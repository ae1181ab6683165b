"""Time the licensed gateway's sampled serving step on one CUDA card.

The stream is ``chip_smoke.py``'s phase 13c: phase 3's 12 requests at
qwen2.5-3b's full width and depth (bf16, random weights from
``chip_smoke.SEED``), lanes greedy or sampling at temperature 0.8 with
top_k 0, 5 and 50, through a ``LicensedGateway`` in its default (fused
sampling) mode on the kernel route with CUDA graphs.  The first wave
captures the graphs; each later wave is timed on the host clock,
synchronized at its ends, as its ms a step (decode steps and prefill
chunks), and so is every step's sampling epilogue (``gateway._sample``,
synchronized before; it ends with its own copy of the tokens).

``--src DIR`` serves with the ``repro_torch`` package under ``DIR/src``
(default: this checkout), so that two trees of the repository can be
timed in one call on one card, each in a process of its own; the
kernels build under that tree.

Usage:
  python3 scripts/sampled_step.py [--src DIR] [--waves 4] [--label NAME]

Prints one JSON line: the per-wave ms a step, their median, the median
epilogue ms, and the number of sampled tokens a wave.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(HERE), help="the tree whose src/repro_torch serves")
    ap.add_argument("--waves", type=int, default=4, help="waves, the first one untimed")
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    src = Path(args.src).resolve() / "src"
    if not (src / "repro_torch").is_dir():
        ap.error(f"no repro_torch under {src}")
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(HERE))
    import numpy as np
    import torch

    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.core.licensing import LicenseTier
    from repro_torch.models import init_params
    from repro_torch.serving import LicensedGateway

    if not torch.cuda.is_available():
        smoke.fail("no CUDA card")
    cfg = get_config(smoke.ARCH)
    params = init_params(cfg, seed=smoke.SEED, device="cuda")
    tiers = {"free": LicenseTier(name="free", masks=smoke.FREE_TIER),
             "pro": LicenseTier(name="pro", masks=smoke.ENGINE_PRO)}
    gw = LicensedGateway(cfg, params, tiers=tiers, device="cuda", **smoke.GEOMETRY)
    epilogue, epilogues = gw._sample, []

    def timed(*a, **k):
        smoke.sync()
        t0 = time.perf_counter()
        toks = epilogue(*a, **k)
        epilogues.append(1e3 * (time.perf_counter() - t0))
        return toks

    gw._sample = timed
    waves, sampled = [], 0
    for w in range(args.waves):
        if w == 1:
            epilogues.clear()
        reqs = smoke.serve_wave(f"wave {w}", gw, cfg, np)
        ms = reqs.pop()
        if w:
            waves.append(ms)
            sampled = sum(len(r.out_tokens) for r in reqs if r.temperature > 0)
    print(json.dumps(dict(label=args.label or str(src.parent), src=str(src.parent),
                          device=torch.cuda.get_device_name(0), ms_per_step=waves,
                          ms_per_step_median=float(np.median(waves)),
                          epilogue_ms_median=float(np.median(epilogues)),
                          epilogues=len(epilogues), sampled_tokens_per_wave=sampled)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
