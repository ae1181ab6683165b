"""One rank of ``tests/test_torch_mesh.py``'s gloo world: the port's
sharded ``prefill_step`` and ``serve_step`` on a (2, 2) mesh,
qwen2.5-3b's int8 store on (1, 4), where its 2 kv heads do not divide
over the query heads' 4 shards: the in-scan int8 dequant's leaves
gathered back whole, and its steps, and qwen2.5-3b's steps at an uneven
batch, ``UNEVEN`` rows on a (4, 1) mesh.  qwen2.5-3b's float steps on
(2, 2) and its in-scan steps on (1, 4) run once more through
``serving.compiled.MeshGraphs`` on :class:`GuardedRecorder`, every
warm-up, capture and replay under :class:`HostSyncGuard`.  Imports no
JAX: the weights come as ``.npz`` files of the JAX package's flat
params, and rank 0 writes what it saw to ``out.npz`` in the same
directory.  ``run`` takes the archs to run (the test spawns one world
per arch; qwen2.5-3b's world runs its int8, graph and uneven steps)."""
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

ARCHS = ("qwen2.5-3b", "deepseek-moe-16b", "mamba2-130m")
B, S, CAP, STEPS = 4, 8, 16, 4
UNEVEN = 2                   # rows over 4 data ranks


def config(arch):
    """The smoke variant in f32; qwen2.5-3b's vocab cut to 500 so that
    the padded-vocab mask runs on vocab-sharded logits."""
    from repro_torch.configs import get_config, smoke_variant

    cfg = smoke_variant(get_config(arch))
    return cfg.replace(vocab_size=500) if arch == "qwen2.5-3b" else cfg


def tokens(arch, rows=B):
    return np.random.default_rng(len(arch)).integers(0, 500, (rows, S), dtype=np.int64)


def _full(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()


def sharded_steps(cfg, params, toks, mesh, license_intervals=None):
    """Prefill then ``STEPS`` greedy decode steps with every param and
    cache leaf placed on ``mesh`` by the partition rules and the tokens
    batch-sharded, under ``implicit_replication``: (logits of each step
    gathered, (steps + 1, B, V); tokens (steps, B)); B is ``toks``' rows."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distribution import sharding as shd
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import prefill_step, serve_step

    b = toks.shape[0]
    dp = shd.distribute_tree(params, shd.params_shardings(params, mesh, cfg), mesh)
    cache = model_lib.init_cache(cfg, b, CAP, device="cpu")
    cache = shd.distribute_tree(cache, shd.cache_shardings(cache, mesh, b), mesh)

    def place(t):
        return shd.distribute_tree({"t": t}, shd.data_shardings({"t": t}, mesh), mesh)["t"]

    logits, out = [], []
    with implicit_replication():
        lg, cache = prefill_step(dp, cfg, place(torch.from_numpy(toks)), cache,
                                 license_intervals=license_intervals)
        logits.append(_full(lg))
        for i in range(STEPS):
            nxt = torch.from_numpy(logits[-1].argmax(-1)[:, None])
            out.append(nxt[:, 0].numpy())
            pos = torch.full((b,), S + i, dtype=torch.int32)
            lg, cache = serve_step(dp, cfg, place(nxt), cache, pos, license_intervals)
            logits.append(_full(lg))
    return np.stack(logits), np.stack(out)


class HostSyncGuard(TorchDispatchMode):
    """Raises on an op that waits for the host: ``nonzero``,
    ``_local_scalar_dense`` (``.item()``), ``masked_select``, and
    ``index`` or ``index_put_`` with a boolean index (a ``nonzero``
    inside).  A CUDA graph capture refuses these; this is its stand-in
    on the CPU.  A ``DTensor`` op is left to DTensor, whose local ops
    then come through here.

    One site is let through: the body of ``serving.quantized.
    dequant_tree``, whose trim of a tier's live intervals runs under
    ``device.type == "cpu"`` only (the plain dequant loops over the slots
    it is given); on the card the kernel takes all MAX_INTERVALS slots."""

    REFUSED = ("aten::nonzero", "aten::_local_scalar_dense", "aten::masked_select")
    BOOL_INDEXED = ("aten::index", "aten::index_put", "aten::index_put_")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = func._schema.name
        if (name in self.REFUSED or (name in self.BOOL_INDEXED and any(
                t is not None and t.dtype in (torch.bool, torch.uint8) for t in args[1]))) \
                and not self._cpu_only_site():
            raise RuntimeError(f"{func} synchronizes with the host inside a capture")
        return func(*args, **(kwargs or {}))

    @staticmethod
    def _cpu_only_site() -> bool:
        """Whether the nearest caller outside torch is ``dequant_tree``'s
        own body."""
        from repro_torch.serving import quantized

        torch_dir = Path(torch.__file__).parent
        f = sys._getframe(2)
        while f is not None and (Path(f.f_code.co_filename).is_relative_to(torch_dir)
                                 or f.f_code.co_filename == __file__):
            f = f.f_back
        return f is not None and f.f_code is quantized.dequant_tree.__code__


class GuardedRecorder:
    """A capture backend for the CPU: the warm-up runs the step, the
    capture runs it once more (what a capture records; a prefill's
    zeroes its cache first, a decode's state is put back after it) and
    returns it, and a replay runs it again, each under
    :class:`HostSyncGuard`.  What the kernel wrappers count in a capture
    or a replay is taken back: neither launches through a wrapper on the
    card."""

    def __init__(self):
        self.captures = 0
        self.replays = 0

    def warmup(self, fn):
        with HostSyncGuard():
            fn()

    def capture(self, fn):
        self.captures += 1
        self._uncounted(fn)
        return fn

    def replay(self, fn):
        self.replays += 1
        self._uncounted(fn)

    def _uncounted(self, fn):
        from repro_torch.kernels import ops

        counted = dict(ops.LAUNCHES)
        with HostSyncGuard():
            fn()
        ops.LAUNCHES.clear()
        ops.LAUNCHES.update(counted)


def graph_steps(cfg, params, toks, mesh=None, license_intervals=None):
    """``sharded_steps``' schedule through ``MeshGraphs`` on a
    :class:`GuardedRecorder` (plain tensors with no ``mesh``): (logits
    (steps + 1, B, V), tokens (steps, B), [captures, replays])."""
    from repro_torch.distribution import sharding as shd
    from repro_torch.serving.compiled import MeshGraphs

    if mesh is not None:
        params = shd.distribute_tree(params, shd.params_shardings(params, mesh, cfg), mesh)
    graphs = MeshGraphs(cfg, params, mesh=mesh, backend=GuardedRecorder())
    lg, greedy = graphs.prefill(toks, CAP, intervals=license_intervals)
    logits, out = [lg.numpy().copy()], []
    for i in range(STEPS):
        out.append(greedy.numpy().copy())
        lg, greedy = graphs.decode(greedy, S + i, CAP, intervals=license_intervals)
        logits.append(lg.numpy().copy())
    return np.stack(logits), np.stack(out), np.array([graphs.captures, graphs.replays])


def run(rank: int, world: int, where: str, archs) -> None:
    torch.set_num_threads(1)
    d = Path(where)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.core.licensing import LicenseTier
        from repro_torch.core.pytree_io import flatten_params
        from repro_torch.distribution import sharding as shd
        from repro_torch.models import model as model_lib
        from repro_torch.serving.quantized import (dequant_tree, quantize_serving_params,
                                                   tier_intervals)

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        tp = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
        dp = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
        out = {}
        for arch in archs:
            cfg = config(arch)
            params = model_lib.params_from_jax(dict(np.load(d / f"{arch}.npz")), device="cpu")
            out[f"{arch}/logits"], out[f"{arch}/tokens"] = sharded_steps(
                cfg, params, tokens(arch), mesh)
            if arch == "qwen2.5-3b":           # int8 under tensor parallelism of 4
                out["graph/logits"], out["graph/tokens"], out["graph/counts"] = graph_steps(
                    cfg, params, tokens(arch), mesh)
                store = quantize_serving_params(params)
                li = tier_intervals(LicenseTier(name="free", masks={"*": ((0.0, 0.01),)}),
                                    device="cpu")
                ds = shd.distribute_tree(store, shd.params_shardings(store, tp, cfg), tp)
                with implicit_replication():
                    for u in range(cfg.pattern_units):
                        view = dequant_tree(model_lib._unit(ds["units"], u), li, cfg.dtype)
                        for name, leaf in flatten_params(view).items():
                            out[f"int8/units/{u}/{name}"] = _full(leaf)
                out["int8/logits"], out["int8/tokens"] = sharded_steps(
                    cfg, store, tokens(arch), tp, license_intervals=li)
                out["int8_graph/logits"], out["int8_graph/tokens"], \
                    out["int8_graph/counts"] = graph_steps(cfg, store, tokens(arch), tp, li)
                out["uneven/logits"], out["uneven/tokens"] = sharded_steps(
                    cfg, params, tokens(arch, UNEVEN), dp)
        if rank == 0:
            np.savez(d / "out.npz", **out)
    finally:
        dist.destroy_process_group()
