"""One rank of ``tests/test_torch_mesh.py``'s gloo world: the port's
sharded ``prefill_step`` and ``serve_step`` on a (2, 2) mesh,
qwen2.5-3b's int8 store on (1, 4), where its 2 kv heads do not divide
over the query heads' 4 shards: the in-scan int8 dequant's leaves
gathered back whole, and its steps, and qwen2.5-3b's steps at an uneven
batch, ``UNEVEN`` rows on a (4, 1) mesh.  Imports no JAX: the weights come as ``.npz`` files of the
JAX package's flat params, and rank 0 writes what it saw to
``out.npz`` in the same directory."""
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

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


def run(rank: int, world: int, where: str) -> None:
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
        for arch in ARCHS:
            cfg = config(arch)
            params = model_lib.params_from_jax(dict(np.load(d / f"{arch}.npz")), device="cpu")
            out[f"{arch}/logits"], out[f"{arch}/tokens"] = sharded_steps(
                cfg, params, tokens(arch), mesh)
            if arch == "qwen2.5-3b":           # int8 under tensor parallelism of 4
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
                out["uneven/logits"], out["uneven/tokens"] = sharded_steps(
                    cfg, params, tokens(arch, UNEVEN), dp)
        if rank == 0:
            np.savez(d / "out.npz", **out)
    finally:
        dist.destroy_process_group()
