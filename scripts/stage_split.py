"""Where a staged sync's STAGE steps spend their host time, on one tree of
the port: this checkout's, or the package of an older checkout.

    python3 scripts/stage_split.py [--src DIR] [--layers N] [--label NAME]

Runs chip_smoke.py's update path once on one CUDA card: qwen2.5-3b at
full width (depth cut to ``--layers`` when given) from the seed, v1
published to an in-memory ``WeightStore``, a float gateway booted
``from_server``, phase 3's request stream, and v2 (``make_v2``: the last
4 units changed) staged mid-stream in 16 MB steps.  The package is
imported from ``--src`` (default: this checkout's ``src``), so two trees
can be held against each other in one call on one card, in turns (an
older tree's graph backend gets this checkout's pool that outlives its
graphs, without which its post-flip captures fail).  The
STAGE steps run under ``chip_smoke.StageProbe``: host-clock laps around
what the stager calls, the per-page route (a pageable copy and a slice
copy a page) split as queue wait, page decode, host copies, pageable
host-to-device copies, launches and layer clones; the parts route
(``delta_apply_parts``) as queue wait, page decode into segments, layer
clones, plan, pack into pinned memory, slot wait, upload and launch.
The third stage step is profiled (its stager step's own device records
counted apart) and left out of the split.  Prints one JSON line: the
card, the route, the split in ms per stage step, ``h_stager`` p50 and
p99, the median and longest synchronized scheduler step during the
sync, begin->flip, and the profiled step's records.  Exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds the repro_torch package to run")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut qwen2.5-3b to this many layers (default: all 36)")
    ap.add_argument("--label", default="stage split")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path[:0] = [str(src), str(ROOT)]
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import load_extension

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    cs.log(f"{args.label}: {card}; repro_torch from {src}")
    load_extension()
    from repro_torch.serving import compiled

    if "MemPool" not in inspect.getsource(compiled.CudaGraphBackend.__init__):
        # an older tree's graph pool is a bare handle, which a capture after
        # every graph of it was dropped (the flip) cannot reuse: hold each
        # backend's pool with a MemPool, as this checkout's compiled.py does
        init = compiled.CudaGraphBackend.__init__

        def held_pool(self, device):
            init(self, device)
            with torch.cuda.device(self.device):
                self._mempool = torch.cuda.MemPool()
            self.pool = self._mempool.id

        compiled.CudaGraphBackend.__init__ = held_pool
    cfg = get_config(cs.ARCH)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    out = cs.update_phase(args.label, cfg, {}, torch, np, profile_stage=True)
    prof = out["stager_histogram"].get("profile") or {}
    line = dict(label=args.label, card=card, src=str(src), layers=cfg.num_layers,
                stage=out["stage"], h_stager_p50_ms=out["stager_histogram"]["p50_ms"],
                h_stager_p99_ms=out["stager_histogram"]["p99_ms"],
                step_ms_during=out["step_ms"]["during"], begin_to_flip_s=out["begin_to_flip_s"],
                sync_steps_by_phase=out["sync_steps_by_phase"],
                profiled_stager_span_ms=out["stager_histogram"].get("stager_span_ms"),
                profiled_step=dict((k, prof.get(k)) for k in (
                    "window_ms", "device_busy_ms", "kernel_launches_per_step",
                    "copies_and_sets_per_step", "host_launch_calls_per_step")))
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
