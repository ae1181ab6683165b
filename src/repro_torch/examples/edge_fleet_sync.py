"""Edge-fleet synchronization on the port: many devices, mixed licenses,
shard-aware delta distribution.

Simulates a fleet of edge clients on different versions pulling from one
LicenseServer, then a *sharded* consumer (a 4-host serving pod) where each
host fetches only its shard's slice of the delta.  On the card every pull
applies its packet with the ``delta_apply`` kernel.

Run:  PYTHONPATH=src python -m repro_torch.examples.edge_fleet_sync [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.paper_mlp import TABLE1_A
from repro_torch.core import flatten_params, shard_delta, tree_map, unflatten_like
from repro_torch.core.licensing import LicenseTier
from repro_torch.core.protocol import EdgeClient, LicenseServer
from repro_torch.core.weightstore import WeightStore
from repro_torch.data import classification_data
from repro_torch.examples import launches, parse, parser
from repro_torch.training import mlp_accuracy, train_mlp


def main(argv=None) -> dict:
    args = parse(parser(__doc__), argv)
    x, y = classification_data(4000, TABLE1_A.in_dim, TABLE1_A.num_classes, seed=0)
    nested = train_mlp(TABLE1_A, x, y, steps=300, device=args.device)
    params = flatten_params(nested)

    store = WeightStore(":memory:")
    store.register_model("fleet", "mlp")
    server = LicenseServer(store)
    server.publish("fleet", params, tag="v1")
    server.publish_tier("fleet", LicenseTier(
        name="free", masks={"layer1": ((0.5, 0.8),)}, accuracy=0.7))

    zeros = tree_map(torch.zeros_like, params)
    fleet = [EdgeClient("fleet", dict(zeros),
                        license_name="free" if i % 2 else "full")
             for i in range(6)]
    for c in fleet:
        c.request_update(server)

    # three incremental server versions while half the fleet sleeps
    cur = params
    rng = np.random.default_rng(1)
    for v in range(3):
        cur = tree_map(torch.clone, cur)
        flat = cur["layer2/kernel"].view(-1)
        hit = rng.choice(flat.numel(), 50, replace=False)
        flat[torch.from_numpy(hit).to(flat.device)] += 0.05
        server.publish("fleet", cur, tag=f"v1.{v + 1}")
        for c in fleet[: 3]:  # only awake clients sync each round
            c.request_update(server)
    for c in fleet[3:]:       # sleepers catch up in ONE combined packet
        c.request_update(server)

    out = {"clients": []}
    for i, c in enumerate(fleet):
        acc = mlp_accuracy(unflatten_like(nested, c.params), x, y)
        out["clients"].append(dict(license=c.license_name, version=c.version,
                                   downloads=c.updates, bytes=c.bytes_downloaded, acc=acc))
        print(f"client {i} [{c.license_name:4s}] v{c.version} "
              f"downloads={c.updates} bytes={c.bytes_downloaded} "
              f"acc={acc:.3f}")

    # shard-aware distribution: a 4-way sharded serving pod pulls the delta
    packet = server.handle_update("fleet", fleet[0].version - 3)
    size = params["layer2/kernel"].numel()
    out["combined_bytes"], out["shards"] = packet.nbytes, []
    print("\nshard-aware pull of the combined delta (layer2/kernel):")
    for host in range(4):
        lo, hi = host * size // 4, (host + 1) * size // 4
        part = shard_delta(packet, {"layer2/kernel": (lo, hi)})
        out["shards"].append(dict(bytes=part.nbytes, entries=part.num_entries))
        print(f"  host{host}: {part.nbytes:5d}B "
              f"({part.num_entries} entries) of {packet.nbytes}B total")
    store.close()
    out["launches"] = launches()
    return out


if __name__ == "__main__":
    main()
