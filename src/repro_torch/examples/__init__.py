"""The README's examples as the port's entry points.

One module per script of the repository's ``examples/``, under the same
name, taking the same steps at the same sizes and printing the same
lines::

    python -m repro_torch.examples.quickstart            # on the card
    python -m repro_torch.examples.quickstart --device cpu

Each module's ``main(argv=None)`` returns the numbers it prints, with
``launches``: the kernel launches of its run (``kernels.ops.LAUNCHES``,
zeroed when ``main`` starts).  ``--device`` defaults to ``cuda``; asking
for it without a card raises, and an example that fails raises, so the
process exits non-zero.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

NAMES = ("quickstart", "edge_fleet_sync", "train_lm_with_versioned_checkpoints",
         "licensed_serving", "gateway_serving", "fleet_serving", "observability",
         "chaos_sync")


def parser(doc: Optional[str]) -> argparse.ArgumentParser:
    """The examples' common arguments (``--device``); a module adds its
    own before parsing."""
    ap = argparse.ArgumentParser(description=(doc or "").split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; the tests pass cpu)")
    return ap


def parse(ap: argparse.ArgumentParser, argv: Optional[Sequence[str]]):
    """Parse ``argv`` and zero the launch counters; ``--device`` becomes a
    ``torch.device``, and a CUDA device without a card raises, so no
    example falls back to the CPU unasked."""
    from repro_torch.kernels import ops

    args = ap.parse_args(None if argv is None else list(argv))
    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: torch.cuda.is_available() is false "
                           f"(pass --device cpu to run on the CPU)")
    ops.reset_launches()
    return args


def launches() -> dict:
    """The kernel launches counted since :func:`parse`."""
    from repro_torch.kernels import ops

    return dict(ops.LAUNCHES)


def check(ok: bool, msg: str) -> None:
    """An example's own invariant (the JAX scripts' asserts): raise when
    it does not hold."""
    if not ok:
        raise RuntimeError(msg)
