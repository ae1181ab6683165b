"""Quickstart: the paper's full lifecycle in one script, on the port.

1. train the paper's 3-layer MLP to ~98% accuracy;
2. compress it (prune 80% -> fine-tune -> quantize, Fig. 3);
3. publish to the versioned WeightStore (Fig. 4 schema);
4. calibrate a free tier with Algorithm 1 and register it;
5. two edge clients (full / free license) pull the model — the free one
   receives interval-masked weights and lower accuracy;
6. push a small server-side update; clients low-latency-delta-sync (§4.3).

On the card the pulls apply their packets with the ``delta_apply``
kernel.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch.configs.paper_mlp import TABLE1_A
from repro_torch.core import (compress_pipeline, flatten_params, tree_map,
                              unflatten_like)
from repro_torch.core.licensing import calibrate_license
from repro_torch.core.protocol import EdgeClient, LicenseServer
from repro_torch.core.weightstore import WeightStore
from repro_torch.data import classification_data
from repro_torch.examples import check, launches, parse, parser
from repro_torch.training import finetune_pruned_mlp, mlp_accuracy, train_mlp

UPDATED = 25          # weights the step-6 update changes


def data():
    """The classification task: (x_train, y_train, x_test, y_test)."""
    x, y = classification_data(8000, TABLE1_A.in_dim, TABLE1_A.num_classes, seed=0)
    return x[:6000], y[:6000], x[6000:], y[6000:]


def main(argv=None, *, train=train_mlp, finetune=finetune_pruned_mlp) -> dict:
    """The six steps; returns the numbers they print.  ``train`` and
    ``finetune`` stand in for ``train_mlp`` and ``finetune_pruned_mlp``
    (same arguments, same result), so a caller can wrap steps 1-2."""
    args = parse(parser(__doc__), argv)
    out = {}

    # 1. train ----------------------------------------------------------------
    xtr, ytr, xte, yte = data()
    params = train(TABLE1_A, xtr, ytr, steps=600, device=args.device)
    out["trained_acc"] = mlp_accuracy(params, xte, yte)
    out["num_params"] = TABLE1_A.num_params
    print(f"[1] trained paper MLP ({TABLE1_A.num_params} params): "
          f"acc={out['trained_acc']:.3f}")

    # 2. compress (Fig. 3) ----------------------------------------------------
    pruned, _, stats = compress_pipeline(params, sparsity=0.8)
    pruned = finetune(TABLE1_A, pruned, xtr, ytr, steps=200)
    out["pruned_acc"] = mlp_accuracy(pruned, xte, yte)
    out["full_bytes"], out["quantized_bytes"] = stats.full_bytes, stats.quantized_bytes
    print(f"[2] pruned 80% + fine-tuned: acc={out['pruned_acc']:.3f}  "
          f"storage {stats.full_bytes / 1e6:.2f}MB -> {stats.quantized_bytes / 1e6:.2f}MB")

    # 3. publish --------------------------------------------------------------
    store = WeightStore(":memory:")
    store.register_model("prod-mlp", "paper-mlp")
    server = LicenseServer(store)
    out["version"] = server.publish("prod-mlp", pruned, tag="v1.0")
    out["db_rows"] = store.storage_bytes("prod-mlp")["weight_rows"]
    print(f"[3] published version {out['version']}; DB rows: {out['db_rows']}")

    # 4. calibrate the free tier (Algorithm 1, dynamic licensing) -------------
    tier, trace = calibrate_license(
        pruned, lambda p: mlp_accuracy(p, xte, yte), target_accuracy=0.70,
        k_intervals=12, tier_name="free",
    )
    server.publish_tier("prod-mlp", tier)
    out["tier_accuracy"], out["evaluations"] = tier.accuracy, len(trace)
    print(f"[4] calibrated tier 'free': accuracy {tier.accuracy:.3f} "
          f"after {len(trace)} Algorithm-1 evaluations")

    # 5. licensed clients pull ------------------------------------------------
    zeros = tree_map(torch.zeros_like, flatten_params(pruned))
    paid = EdgeClient("prod-mlp", dict(zeros), license_name="full")
    free = EdgeClient("prod-mlp", dict(zeros), license_name="free")
    paid.request_update(server)
    free.request_update(server)
    out["paid_acc"] = mlp_accuracy(unflatten_like(pruned, paid.params), xte, yte)
    out["free_acc"] = mlp_accuracy(unflatten_like(pruned, free.params), xte, yte)
    print(f"[5] paid client acc={out['paid_acc']:.3f}, free client acc={out['free_acc']:.3f} "
          f"(one stored model, two licenses)")
    check(out["free_acc"] < out["paid_acc"],
          f"the free client's accuracy {out['free_acc']} is not below the paid "
          f"client's {out['paid_acc']}")
    check(out["paid_acc"] == out["pruned_acc"],
          f"the paid client's accuracy {out['paid_acc']} is not the pruned model's "
          f"{out['pruned_acc']}")

    # 6. low-latency update ---------------------------------------------------
    newp = tree_map(torch.clone, flatten_params(pruned))
    newp["layer3/kernel"].view(-1)[:UPDATED] += 0.01
    server.publish("prod-mlp", newp, tag="v1.1")
    packet = paid.request_update(server)
    out["delta_entries"], out["delta_bytes"] = packet.num_entries, packet.nbytes
    out["initial_bytes"] = paid.bytes_downloaded - packet.nbytes
    print(f"[6] delta update: {packet.num_entries} weights, {packet.nbytes}B "
          f"(vs {out['initial_bytes']}B initial download)")
    check(packet.num_entries == UPDATED,
          f"the delta packet holds {packet.num_entries} entries, not {UPDATED}")
    store.close()
    out["launches"] = launches()
    return out


if __name__ == "__main__":
    main()
