"""Dry run of the port: every (arch × input shape) on the ``meta`` device,
sized against one card.

Counterpart of ``repro/launch/dryrun.py`` without the mesh: the JAX
package lowers and compiles each combination for a 256- or 512-chip
mesh and reads flops and bytes from the compiled HLO; here the port's
own step runs on ``meta`` tensors (shapes and dtypes, no storage, no
arithmetic) under ``torch.utils.flop_counter.FlopCounterMode``:
``engine.prefill_step``, ``engine.serve_step`` (over the int8 store with
a tier's intervals under ``--quantized``) or, for a train shape, the JAX
jit site's step: ``make_train_step`` with AdamW, ``grad_accum`` 4 in the
sweep (``lm_loss`` forward and backward a micro-batch, the f32
accumulation, the update).  Each combination reports the counted flops
beside ``roofline.model_step_flops``, the weight and cache bytes, whether they
fit one card, and the roofline terms (``launch/roofline.py``), the
card's peaks and memory both from ``roofline.present_card`` (the card
present, else an H100 80GB).  Nothing is allocated and no card is
needed.

With ``--mesh single|multi`` the step runs sharded, as the JAX dry run
compiles it: :func:`repro_torch.launch.mesh.fake_world` makes a world of
256 (16x16) or 512 (2x16x16) ranks in this one process, and the params,
the cache, the inputs and the AdamW state (its moments ZeRO-1) become
``meta`` DTensors placed by ``distribution.sharding``.  The step runs
under ``implicit_replication`` (its own plain tensors, masks and
positions, count as replicated), ``FlopCounterMode`` (the global flops)
and ``op_cost.OpCostMode``, which counts the collectives DTensor
inserts, as one rank issues them.  The
report then adds ``mesh``, ``chips``, the collective bytes and counts by
kind and the collective term, and its ``weight_bytes``, ``cache_bytes``,
``write_bytes`` and ``resident_bytes`` are one rank's local shards: a
lower bound, with no temporaries.  On the CPU mesh DTensor turns an
all-to-all into an all-gather and a chunk, and it is counted as such.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--quantized] [--out DIR]
  python -m repro_torch.launch.dryrun --all --mesh single|multi

One JSON line per combination on stdout, and with ``--out`` one file
each in DIR.  A combination that cannot run is reported with its error
and the sweep goes on; the exit code is then 1.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Iterable, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.licensing import LicenseTier
from repro_torch.distribution import sharding as shd
from repro_torch.launch import op_cost
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
            quantized: bool = False, note: str = "", mesh=None,
            cost: Optional[op_cost.OpCostMode] = None, grad_accum: int = 1) -> Dict[str, Any]:
    """Run one step of ``cfg`` at ``shape`` on ``meta`` and report its
    counted flops, bytes and roofline terms (``cfg`` as given: the caller
    adapts it to the shape).  ``quantized`` applies to a decode step,
    ``grad_accum`` (micro-batches; it divides ``shape.batch``) to a train
    step.  ``mesh`` (a ``DeviceMesh`` over the default process group)
    runs the step sharded and reports one rank's bytes and collectives.
    ``cost`` (made here on a mesh) counts the rank's ops
    (``launch/analyze.py`` reads it)."""
    t0 = time.perf_counter()
    kind, spec = input_specs(cfg, shape)
    quantized = quantized and kind == "decode"
    params = model_lib.init_params(cfg, device="meta")
    li = None
    if quantized:
        from repro_torch.serving.quantized import quantize_serving_params, tier_intervals

        params = quantize_serving_params(params)
        li = tier_intervals(FREE, device="meta")
    grown = None
    if kind == "decode":
        # one position of every per-token leaf: the cache's growth by one
        grown = model_lib.init_cache(cfg, shape.batch, shape.seq_len + 1, device="meta")
    nbytes = tree_bytes
    if mesh is not None:
        params, spec, nbytes = _place(params, spec, cfg, shape.batch, mesh)
    weight_bytes = nbytes(params)
    cache_bytes = nbytes(spec.get("cache"))
    write_bytes = 0
    if grown is not None:
        write_bytes = (nbytes(grown) - cache_bytes if mesh is None
                       else _slot_bytes(spec["cache"], grown))
    resident = weight_bytes + cache_bytes
    if kind == "train":
        from repro_torch.training import OptimizerConfig, init_state, make_train_step

        opt_state = init_state(params)
        if mesh is not None:
            opt_state = shd.distribute_tree(
                opt_state, shd.opt_state_shardings(opt_state, params, mesh), mesh)
        train_step = make_train_step(cfg, OptimizerConfig(grad_accum=grad_accum))
        # a micro-batch's gradients in the param dtype, AdamW's two f32
        # moments and, with micro-batches, the f32 accumulators
        resident += weight_bytes + nbytes(opt_state)
        if grad_accum > 1:
            resident += sum(4 * (t.to_local() if isinstance(t, DTensor) else t).numel()
                            for t in _leaves(params))
    if cost is None and mesh is not None:
        cost = op_cost.OpCostMode()
    with contextlib.ExitStack() as modes:
        if mesh is not None:
            modes.enter_context(implicit_replication())
        if cost is not None:
            modes.enter_context(cost)       # under the flop counter: see op_cost
        counter = modes.enter_context(FlopCounterMode(display=False))
        if kind == "train":
            train_step(params, opt_state, spec["batch"])
        elif kind == "prefill":
            prefill_step(params, cfg, spec["tokens"], spec["cache"],
                         patch_embeds=spec.get("patch_embeds"))
        else:
            serve_step(params, cfg, spec["tokens"], spec["cache"], spec["pos"], li)
    card, limit, source = rl.present_card()
    report = rl.build_report(
        arch=arch or cfg.name, shape=shape.name, cfg=cfg, flops=counter.get_total_flops(),
        bytes_=rl.step_bytes(kind, weight_bytes, cache_bytes, write_bytes),
        model_flops=rl.model_step_flops(cfg, shape), card=card, note=note,
        chips=None if mesh is None else mesh.size(),
        collectives=None if mesh is None else cost.collectives)
    out = report.as_dict()
    if mesh is not None:
        coll = cost.collectives
        out.update(mesh="x".join(str(n) for n in mesh.shape),
                   collectives={**{f"{k}_bytes": v for k, v in coll.bytes_by_kind.items()},
                                **{f"{k}_count": v for k, v in coll.count_by_kind.items()}},
                   collective_count=coll.total_count, device_flops=cost.flops,
                   device_traffic_bytes=cost.traffic_bytes)
    if kind == "train":
        out["grad_accum"] = grad_accum
    out.update(step_kind=kind, quantized=quantized, batch=shape.batch,
               seq_len=shape.seq_len, weight_bytes=weight_bytes, cache_bytes=cache_bytes,
               write_bytes=write_bytes, resident_bytes=resident, card_bytes=limit,
               card_bytes_source=source, fits_one_card=resident <= limit,
               bound_s=report.bound_s, run_s=time.perf_counter() - t0)
    return out


def _slot_bytes(cache, grown) -> int:
    """One slot of every per-token leaf of a placed ``cache`` (the leaves
    ``grown``, the cache one position longer, has longer), as one rank
    holds it: the bytes a rank writes when the new position falls in its
    shard."""
    total = 0
    for c, g in zip(_leaves(cache), _leaves(grown)):
        if tuple(c.shape) != tuple(g.shape):
            d = next(i for i, (a, b) in enumerate(zip(c.shape, g.shape)) if a != b)
            loc = c.to_local()
            total += loc.numel() // loc.shape[d] * loc.element_size()
    return total


def _place(params, spec: Dict[str, Any], cfg: ModelConfig, batch: int, mesh):
    """The step's params and inputs as ``meta`` DTensors on ``mesh`` by
    the partition rules (a decode's ``pos`` replicated, as in the JAX
    dry run), and the byte count of one rank's shards: a DTensor tree
    counts its local shards; a plain tree, the grown cache, counts the
    shards its rules give it."""
    placed: Dict[str, Any] = {}
    for name, value in spec.items():
        if name == "cache":
            sh = shd.cache_shardings(value, mesh, batch)
        elif name == "batch":
            sh = shd.data_shardings(value, mesh)
        elif name == "pos":
            sh = shd.replicated(mesh)
        else:
            sh = shd.data_shardings({name: value}, mesh)[name]
        placed[name] = shd.distribute_tree(value, sh, mesh)
    params = shd.distribute_tree(params, shd.params_shardings(params, mesh, cfg), mesh)

    def nbytes(tree) -> int:
        if tree is None:
            return 0
        if any(isinstance(t, DTensor) for t in _leaves(tree)):
            return shd.local_bytes(tree)
        return shd.sharded_bytes(tree, shd.cache_shardings(tree, mesh, batch), mesh)

    return params, placed, nbytes


# micro-batches of a train step, as the JAX dry run compiles it
GRAD_ACCUM = 4


def run_combo(arch: str, shape_name: str, *, quantized: bool = False,
              mesh=None) -> Dict[str, Any]:
    """One (arch, shape) of the sweep, the config adapted to the shape; a
    train shape at ``GRAD_ACCUM`` micro-batches."""
    shape = SHAPES[shape_name]
    cfg, note = adapt_config(get_config(arch), shape)
    return dry_run(cfg, shape, arch=arch, quantized=quantized, note=note, mesh=mesh,
                   grad_accum=GRAD_ACCUM if shape.kind == "train" else 1)


def production_mesh(kind: str):
    """The fake world and the production mesh of ``--mesh single|multi``
    (the caller destroys the process group when done)."""
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    multi = kind == "multi"
    fake_world(512 if multi else 256)
    return make_production_mesh(multi_pod=multi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=ASSIGNED_ARCHS)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true", help="every assigned arch x shape")
    ap.add_argument("--quantized", action="store_true",
                    help="decode shapes: the int8 store, dequantized in the step")
    ap.add_argument("--out", default=None, help="also write one JSON file per combo here")
    ap.add_argument("--mesh", choices=["single", "multi"], default=None,
                    help="run sharded on a fake 16x16 (single) or 2x16x16 (multi) world")
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

    kw = {}
    if args.mesh:
        kw["mesh"] = production_mesh(args.mesh)
    failures = 0
    try:
        for arch, shape in combos:
            tag = (f"{arch}__{shape}" + (f"__{kw['mesh'].size()}" if kw else "")
                   + ("__int8" if args.quantized else ""))
            try:
                rep = run_combo(arch, shape, quantized=args.quantized, **kw)
            except Exception as e:  # noqa: BLE001 - report and continue the sweep
                failures += 1
                rep = {"arch": arch, "shape": shape, "error": f"{type(e).__name__}: {e}"}
                traceback.print_exc()
            line = json.dumps(rep)
            print(line, flush=True)
            if outdir is not None:
                (outdir / f"{tag}.json").write_text(line + "\n")
    finally:
        if kw:
            torch.distributed.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
