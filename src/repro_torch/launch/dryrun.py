"""Dry run of the port: every (arch × input shape) on the ``meta`` device,
sized against one card.

Counterpart of ``repro/launch/dryrun.py`` without the mesh: the JAX
package lowers and compiles each combination for a 256- or 512-chip
mesh and reads flops and bytes from the compiled HLO; here the port's
own step runs on ``meta`` tensors (shapes and dtypes, no storage, no
arithmetic) under ``torch.utils.flop_counter.FlopCounterMode``:
``engine.prefill_step``, ``engine.serve_step`` (over the int8 store with
a tier's intervals under ``--quantized``) or ``lm_loss`` forward and
backward.  Each combination reports the counted flops beside
``roofline.model_step_flops``, the weight and cache bytes, whether they
fit one card, and the roofline terms (``launch/roofline.py``), the
card's peaks and memory both from ``roofline.present_card`` (the card
present, else an H100 80GB).  Nothing is allocated and no card is
needed.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--quantized] [--out DIR]

One JSON line per combination on stdout, and with ``--out`` one file
each in DIR.  A combination that cannot run is reported with its error
and the sweep goes on; the exit code is then 1.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Iterable, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.licensing import LicenseTier
from repro_torch.launch import roofline as rl
from repro_torch.launch.shapes import SHAPES, InputShape, adapt_config, input_specs
from repro_torch.models import model as model_lib
from repro_torch.serving.engine import prefill_step, serve_step

# the tier whose intervals an int8 decode dequantizes with (the launcher's
# ``free``: |w| < 0.01 masked everywhere)
FREE = LicenseTier(name="free", masks={"*": ((0.0, 0.01),)})


def _leaves(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def dry_run(cfg: ModelConfig, shape: InputShape, *, arch: Optional[str] = None,
            quantized: bool = False, note: str = "") -> Dict[str, Any]:
    """Run one step of ``cfg`` at ``shape`` on ``meta`` and report its
    counted flops, bytes and roofline terms (``cfg`` as given: the caller
    adapts it to the shape).  ``quantized`` applies to a decode step."""
    t0 = time.perf_counter()
    kind, spec = input_specs(cfg, shape)
    quantized = quantized and kind == "decode"
    params = model_lib.init_params(cfg, device="meta")
    li = None
    if quantized:
        from repro_torch.serving.quantized import quantize_serving_params, tier_intervals

        params = quantize_serving_params(params)
        li = tier_intervals(FREE, device="meta")
    weight_bytes = tree_bytes(params)
    cache_bytes = tree_bytes(spec.get("cache"))
    write_bytes = 0
    if kind == "decode":
        # one position of every per-token leaf: the cache's growth by one
        write_bytes = tree_bytes(model_lib.init_cache(
            cfg, shape.batch, shape.seq_len + 1, device="meta")) - cache_bytes
    resident = weight_bytes + cache_bytes
    if kind == "train":
        from repro_torch.training.optimizer import init_state

        # gradients and AdamW's two f32 moments beside the weights
        resident += weight_bytes + tree_bytes(init_state(params))
        for t in _leaves(params):
            if t.is_floating_point():
                t.requires_grad_(True)
    with FlopCounterMode(display=False) as counter:
        if kind == "train":
            batch = spec["batch"]
            loss, _ = model_lib.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                                        patch_embeds=batch.get("patch_embeds"))
            loss.backward()
        elif kind == "prefill":
            prefill_step(params, cfg, spec["tokens"], spec["cache"],
                         patch_embeds=spec.get("patch_embeds"))
        else:
            serve_step(params, cfg, spec["tokens"], spec["cache"], spec["pos"], li)
    card, limit, source = rl.present_card()
    report = rl.build_report(
        arch=arch or cfg.name, shape=shape.name, cfg=cfg, flops=counter.get_total_flops(),
        bytes_=rl.step_bytes(kind, weight_bytes, cache_bytes, write_bytes),
        model_flops=rl.model_step_flops(cfg, shape), card=card, note=note)
    out = report.as_dict()
    out.update(step_kind=kind, quantized=quantized, batch=shape.batch,
               seq_len=shape.seq_len, weight_bytes=weight_bytes, cache_bytes=cache_bytes,
               write_bytes=write_bytes, resident_bytes=resident, card_bytes=limit,
               card_bytes_source=source, fits_one_card=resident <= limit,
               bound_s=report.bound_s, run_s=time.perf_counter() - t0)
    return out


def run_combo(arch: str, shape_name: str, *, quantized: bool = False) -> Dict[str, Any]:
    """One (arch, shape) of the sweep, the config adapted to the shape."""
    shape = SHAPES[shape_name]
    cfg, note = adapt_config(get_config(arch), shape)
    return dry_run(cfg, shape, arch=arch, quantized=quantized, note=note)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=ASSIGNED_ARCHS)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true", help="every assigned arch x shape")
    ap.add_argument("--quantized", action="store_true",
                    help="decode shapes: the int8 store, dequantized in the step")
    ap.add_argument("--out", default=None, help="also write one JSON file per combo here")
    args = ap.parse_args(argv)
    if args.all:
        combos = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    outdir = None
    if args.out:
        outdir = Path(args.out)
        if "benchmarks" in outdir.resolve().parts:
            ap.error("--out must not lie under benchmarks/")
        outdir.mkdir(parents=True, exist_ok=True)

    failures = 0
    for arch, shape in combos:
        tag = f"{arch}__{shape}" + ("__int8" if args.quantized else "")
        try:
            rep = run_combo(arch, shape, quantized=args.quantized)
        except Exception as e:  # noqa: BLE001 - report and continue the sweep
            failures += 1
            rep = {"arch": arch, "shape": shape, "error": f"{type(e).__name__}: {e}"}
            traceback.print_exc()
        line = json.dumps(rep)
        print(line, flush=True)
        if outdir is not None:
            (outdir / f"{tag}.json").write_text(line + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
