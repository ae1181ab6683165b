"""One rank of ``tests/test_torch_mesh_train.py``'s gloo world: the port's
``make_train_step`` (``grad_accum`` ACCUM, AdamW) sharded as the JAX dry
run compiles it, on a (2, 2) and a (1, 4) mesh.  The params are placed
by ``params_shardings``, the AdamW state by ``opt_state_shardings``
(ZeRO-1 moments) and each batch by ``data_shardings``; STEPS steps run
under ``implicit_replication``, each on the last one's outputs, for the
archs ``run`` is given (the test spawns one world per arch).  After
every step each leaf's placements must be its input placements.
Imports no JAX: the weights come as ``.npz`` files of the JAX package's
flat params, and rank 0 writes what it saw (losses, grad norms, the
params and moments gathered whole, the placements that moved) to
``out.npz`` in the same directory."""
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ARCHS = ("qwen2.5-3b", "deepseek-moe-16b", "musicgen-large", "internvl2-26b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, S, ACCUM, STEPS = 8, 16, 4, 2
# test_torch_training.py's optimizer settings (Adam's eps 1e-4, warmup 1)
OCFG = dict(lr=1e-3, eps=1e-4, warmup_steps=1, total_steps=3, grad_accum=ACCUM)


def config(arch):
    """The smoke variant (f32)."""
    from repro_torch.configs import get_config, smoke_variant

    return smoke_variant(get_config(arch))


def batches(cfg):
    """STEPS batches of B x S tokens and labels (a few masked), drawn with
    numpy; ``patch_embeds`` for a vision front end."""
    rng = np.random.default_rng(len(cfg.name))
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int64),
             "labels": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int64)}
        b["labels"][0, :3] = -100
        if cfg.frontend == "vision":
            b["patch_embeds"] = (0.1 * rng.standard_normal(
                (B, cfg.num_patches, cfg.d_model))).astype(np.float32)
        out.append(b)
    return out


def _full(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()


def _specs(tree):
    """{path: placements} of a tree of DTensors (an ``AdamWState`` too)."""
    from repro_torch.distribution import sharding as shd

    out = {}
    shd._map_with_path(lambda path, t: out.setdefault("/".join(path), tuple(t.placements)),
                       tree)
    return out


def sharded_steps(cfg, params, mesh):
    """STEPS steps of the sharded ``make_train_step``: ({name: array} of
    each step's metrics, the params and moments gathered whole after the
    last step, and the paths whose placements moved in any step)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.pytree_io import flatten_params
    from repro_torch.distribution import sharding as shd
    from repro_torch.training import OptimizerConfig, init_state, make_train_step

    step = make_train_step(cfg, OptimizerConfig(**OCFG))
    p = shd.distribute_tree(params, shd.params_shardings(params, mesh, cfg), mesh)
    state = init_state(params)
    state = shd.distribute_tree(state, shd.opt_state_shardings(state, params, mesh), mesh)
    want = {**{f"params/{k}": v for k, v in _specs(p).items()},
            **{f"state/{k}": v for k, v in _specs(state).items()}}
    metrics, moved = {"loss": [], "grad_norm": []}, []
    for b in batches(cfg):
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        b = shd.distribute_tree(b, shd.data_shardings(b, mesh), mesh)
        with implicit_replication():
            p, state, m = step(p, state, b)
        for k in metrics:
            metrics[k].append(float(_full(m[k])))
        got = {**{f"params/{k}": v for k, v in _specs(p).items()},
               **{f"state/{k}": v for k, v in _specs(state).items()}}
        moved += [k for k in want if got.get(k) != want[k]]
    out = {k: np.array(v) for k, v in metrics.items()}
    for prefix, tree in (("params", p), ("m", state.m), ("v", state.v)):
        for name, leaf in flatten_params(tree).items():
            out[f"{prefix}/{name}"] = _full(leaf)
    out["step"] = np.array(int(_full(state.step)))
    out["moved"] = np.array(sorted(set(moved)), dtype=str)
    return out


def run(rank: int, world: int, where: str, archs) -> None:
    torch.set_num_threads(1)
    d = Path(where)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.models import model as model_lib

        meshes = {k: init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
                  for k, shape in MESHES.items()}
        out = {}
        for arch in archs:
            cfg = config(arch)
            params = model_lib.params_from_jax(dict(np.load(d / f"{arch}.npz")), device="cpu")
            for key, mesh in meshes.items():
                for name, v in sharded_steps(cfg, params, mesh).items():
                    out[f"{arch}/{key}/{name}"] = v
        if rank == 0:
            np.savez(d / "out.npz", **out)
    finally:
        dist.destroy_process_group()
