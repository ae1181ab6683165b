"""Dry-run deep-dive: one rank's traffic, flops and collective bytes for
one (arch x shape [x mesh]) step, attributed to the code that issued
them.

Counterpart of ``repro/launch/analyze.py``: where the JAX tool parses
the partitioned HLO and keys each instruction by its ``op_name``, this
one runs the port's step on ``meta`` (``launch/dryrun.py``, on the fake
world of ``--mesh``) under ``op_cost.OpCostMode`` and keys each op by
the innermost ``repro_torch`` frame that issued it.

  PYTHONPATH=src python -m repro_torch.launch.analyze --arch granite-34b \\
      --shape train_4k [--mesh single|multi] [--quantized] [--top 15]
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch.shapes import SHAPES, adapt_config


def analyze(arch: str, shape_name: str, *, mesh=None, quantized: bool = False):
    """(dry-run report, the ``OpCostMode`` that counted the step)."""
    shape = SHAPES[shape_name]
    cfg, note = adapt_config(get_config(arch), shape)
    cost = op_cost.OpCostMode()
    rep = dryrun.dry_run(cfg, shape, arch=arch, quantized=quantized, note=note, mesh=mesh,
                         cost=cost)
    return rep, cost


def print_tables(rep, cost: op_cost.OpCostMode, top: int = 15) -> None:
    """The totals, then the top traffic, flops and collective sites."""
    chips = rep.get("chips", 1)
    print(f"== {rep['arch']} {rep['shape']} on {rep.get('mesh', '1 card')} ({chips} ranks), "
          f"one rank's step")
    print(f"== totals: flops {cost.flops:.3e}  traffic {cost.traffic_bytes / 2**40:.3f} TiB  "
          f"collective {cost.collectives.total_bytes / 2**30:.3f} GiB in "
          f"{cost.collectives.total_count} ops {cost.collectives.count_by_kind}")
    print(f"== memory: weights {rep['weight_bytes'] / 2**30:.3f} GiB  cache "
          f"{rep['cache_bytes'] / 2**30:.3f} GiB  resident {rep['resident_bytes'] / 2**30:.3f} GiB "
          f"(local shards, no temporaries)")
    for title, scale, unit, table in (("traffic", 2**40, "TiB", cost.traffic_by_site),
                                      ("flops", 1e12, "TFLOP", cost.flops_by_site),
                                      ("collectives", 2**30, "GiB", cost.collective_by_site)):
        print(f"\n-- top {title} ({unit}) --")
        for site, v in table.most_common(top):
            print(f"{v / scale:10.4f}  {site}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=ASSIGNED_ARCHS)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default=None)
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    mesh = dryrun.production_mesh(args.mesh) if args.mesh else None
    try:
        rep, cost = analyze(args.arch, args.shape, mesh=mesh, quantized=args.quantized)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    print_tables(rep, cost, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
