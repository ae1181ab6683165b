"""Licensed batched serving across the architecture zoo, on the port.

Instantiates reduced variants of three assigned archs (dense GQA, MoE,
SSM), builds a tier ladder per model, and serves mixed-tier request
batches through ``ServingEngine`` — the paper's dynamic-licensing
deployment (Fig. 2) generalized from a single edge MLP to modern LM
families.  On the card the engine's prefill and decode replay CUDA
graphs.

Run:  PYTHONPATH=src python -m repro_torch.examples.licensed_serving [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier, license_stats
from repro_torch.examples import check, launches, parse, parser
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingEngine

ARCHS = ("qwen2.5-3b", "deepseek-moe-16b", "mamba2-130m")
LICENSES = ("full", "pro", "free", "free")
NEW_TOKENS = 6


def main(argv=None) -> dict:
    args = parse(parser(__doc__), argv)
    rng = np.random.default_rng(0)
    out = {"archs": {}}
    for arch in ARCHS:
        cfg = smoke_variant(get_config(arch))
        params = init_params(cfg, seed=0, device=args.device)
        tiers = {
            "free": LicenseTier(name="free", masks={"*": ((0.0, 0.006),)}),
            "pro": LicenseTier(name="pro", masks={"*": ((0.0, 0.002),)}),
        }
        engine = ServingEngine(cfg, params, tiers=tiers, device=args.device)
        reqs = [
            Request(prompt=rng.integers(0, cfg.vocab_size, 24, dtype=np.int32),
                    max_new_tokens=NEW_TOKENS, license=lic)
            for lic in LICENSES
        ]
        t0 = time.perf_counter()
        engine.generate(reqs)
        dt = time.perf_counter() - t0
        st = license_stats(params, tiers["free"])
        print(f"{arch:22s} served 4 reqs x 6 tok in {dt:.2f}s; "
              f"free tier hides {st['masked_frac'] * 100:.1f}% of weights")
        for r in reqs[:3]:
            print(f"   [{r.license:4s}] {r.out_tokens}")
        check(all(len(r.out_tokens) == NEW_TOKENS for r in reqs),
              f"{arch}: a request did not get its {NEW_TOKENS} tokens")
        out["archs"][arch] = dict(requests=len(reqs),
                                  tokens=[len(r.out_tokens) for r in reqs],
                                  masked_frac=st["masked_frac"], seconds=dt)
    out["launches"] = launches()
    return out


if __name__ == "__main__":
    main()
