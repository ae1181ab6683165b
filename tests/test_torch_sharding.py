"""The port's partition rules (``repro_torch.distribution.sharding``)
against the JAX package's (``repro.distribution.sharding``), on the CPU
and without a process group.

Each case of ``tests/test_sharding.py`` runs again through the port on a
shape-only ``MeshShape``.  Then, for every assigned arch on meshes of
(1, 1), (16, 16) and (2, 16, 16), the port's placements of every leaf
are turned back into a spec (``spec_of``) and must equal the JAX
package's ``PartitionSpec`` exactly (trailing ``None`` entries dropped,
which name no axis): the float params, the int8 store, AdamW's state
(ZeRO-1), the caches and the inputs of every assigned input shape, and
the params of an arch with ``fsdp=True``.  The JAX side runs its
whole-tree functions on a ``jax.sharding.AbstractMesh`` (no devices);
both sides read the port's own ``meta`` trees for names and shapes.
"""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Shard

from repro.configs import get_config as jax_get_config
from repro.distribution import sharding as jshd
from repro.training.optimizer import AdamWState as JaxAdamWState

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.core.pytree_io import flatten_params
from repro_torch.distribution import sharding as shd
from repro_torch.launch.shapes import SHAPES, adapt_config, input_specs
from repro_torch.models import model as model_lib
from repro_torch.serving.quantized import quantize_serving_params
from repro_torch.training.optimizer import init_state
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MESHES = {"1x1": (("data", "model"), (1, 1)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
M16 = shd.MeshShape(("data", "model"), (16, 16))


class FakeMesh:
    """``tests/test_sharding.py``'s shape-only mesh for the JAX rules."""

    def __init__(self, shape):
        self.shape = shape


J16 = FakeMesh({"data": 16, "model": 16})


def trim(spec):
    """A spec without its trailing ``None`` entries."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def port_spec(pls, mesh=M16):
    return shd.spec_of(pls, mesh)


# ------------------------------------- the cases of tests/test_sharding.py
PARAM_CASES = [
    ("embed/tok", (51200, 768), ("model",)),
    ("units/b0/mixer/wq", (36, 2048, 2048), (None, None, "model")),
    ("units/b0/ffn/w_up", (36, 2048, 11008), (None, None, "model")),
    ("units/b0/mixer/wo", (36, 2048, 2048), (None, "model")),
    ("units/b0/ffn/w_down", (36, 11008, 2048), (None, "model")),
    ("units/b0/ffn/experts/w_gate", (27, 64, 2048, 1408), (None, "model")),
    ("units/b0/norm1/norm_scale", (36, 768), ()),
    ("units/b0/mixer/A_log", (36, 768), ()),
    ("units/b0/mixer/conv_w", (36, 768), ()),
    ("units/b0/ffn/router", (36, 768), ()),
    ("embed/tok", (50280, 768), ()),                       # 50280 % 16: replicated
    ("units/b0/mixer/wq/codes", (36, 2048, 2048), (None, None, "model")),
    ("units/b0/mixer/wq/scale", (36, 1, 2048), ()),
]


@pytest.mark.parametrize("name,shape,want", PARAM_CASES)
def test_param_spec_cases(name, shape, want):
    got = port_spec(shd.param_spec(name, shape, M16))
    assert got == want == trim(jshd.param_spec(name, shape, J16))


def test_zero1_opt_spec_adds_data_axis():
    shape = (36, 2048, 2048)
    base = shd.param_spec("units/b0/mixer/wq", shape, M16)
    got = port_spec(shd.opt_spec(base, shape, M16))
    assert "data" in got
    want = jshd.opt_spec(jshd.param_spec("units/b0/mixer/wq", shape, J16), shape, J16)
    assert got == trim(want)


def test_fsdp_spec_shards_largest_free_dim():
    shape = (36, 2048, 11008)
    base = shd.param_spec("units/b0/ffn/w_up", shape, M16)
    got = port_spec(shd.fsdp_spec(base, shape, M16))
    assert got == (None, "data", "model")
    assert got == trim(jshd.fsdp_spec(jshd.param_spec("units/b0/ffn/w_up", shape, J16),
                                      shape, J16))


@pytest.mark.parametrize("batch,mesh,want", [
    (256, "16x16", "data"), (256, "2x16x16", ("pod", "data")), (1, "16x16", None),
    (16, "2x16x16", "data")])
def test_batch_spec_rules(batch, mesh, want):
    names, sizes = MESHES[mesh]
    got = shd.batch_spec(batch, shd.MeshShape(names, sizes))
    assert got == want == jshd.batch_spec(batch, FakeMesh(dict(zip(names, sizes))))


@pytest.mark.parametrize("arch,keys,absent", [
    ("mamba2-130m", ("in_proj", "out_proj"), ()),          # 24 SSD heads % 16
    ("qwen2.5-3b", ("wk", "wv"), ()),                       # 2 kv heads < 16
    ("musicgen-large", (), ("wk",)),                        # 32 kv heads
])
def test_tp_replicate_keywords(arch, keys, absent):
    got = shd.tp_replicate_keywords(get_config(arch), M16)
    assert got == jshd.tp_replicate_keywords(jax_get_config(arch), J16)
    assert all(k in got for k in keys) and not any(k in got for k in absent)


def test_placements_round_trip():
    m3 = shd.MeshShape(*MESHES["2x16x16"])
    pls = shd.placements([("pod", "data"), None, "model"], m3)
    assert pls == (Shard(0), Shard(0), Shard(2))
    assert shd.spec_of(pls, m3) == (("pod", "data"), None, "model")
    assert shd.spec_of(shd.replicated(m3), m3) == ()


# -------------------------------- every leaf of every arch, both packages
def _sds(tree):
    """The port's meta tree as JAX shape structs (same nested dicts)."""
    if isinstance(tree, dict):
        return {k: _sds(v) for k, v in tree.items()}
    return jax.ShapeDtypeStruct(tuple(tree.shape), "float32")


def _jax_specs(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="/"): trim(s.spec)
            for p, s in jax.tree_util.tree_leaves_with_path(tree)}


def _port_specs(tree, mesh):
    flat = flatten_params(tree)
    return {name: shd.spec_of(pls, mesh) for name, pls in flat.items()}


def _compare(port_tree, jax_tree, mesh):
    got, want = _port_specs(port_tree, mesh), _jax_specs(jax_tree)
    assert set(got) == set(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad
    return got


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_every_leaf_matches_jax(arch, mesh_name):
    names, sizes = MESHES[mesh_name]
    mesh = shd.MeshShape(names, sizes)
    jmesh = AbstractMesh(sizes, names)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    params = model_lib.init_params(cfg, device="meta")
    specs = _compare(shd.params_shardings(params, mesh, cfg),
                     jshd.params_shardings(_sds(params), jmesh, jcfg), mesh)
    if mesh_name != "1x1":
        assert any(s for s in specs.values())          # something is sharded

    # the int8 store of one unit and the tail: quantizing is per unit on
    # meta too, and the unit count shards nothing
    pattern = len(cfg.layer_pattern)
    store = quantize_serving_params(model_lib.init_params(
        cfg.replace(num_layers=pattern + cfg.num_layers % pattern), device="meta"))
    _compare(shd.params_shardings(store, mesh, cfg),
             jshd.params_shardings(_sds(store), jmesh, jcfg), mesh)

    state = init_state(params)
    jstate = JaxAdamWState(step=jax.ShapeDtypeStruct((), "int32"), m=_sds(state.m),
                           v=_sds(state.v))
    got = shd.opt_state_shardings(state, params, mesh)
    want = jshd.opt_state_shardings(jstate, _sds(params), jmesh)
    assert shd.spec_of(got.step, mesh) == trim(want.step.spec) == ()
    _compare(got.m, want.m, mesh)
    _compare(got.v, want.v, mesh)

    for shape in SHAPES.values():
        acfg, _ = adapt_config(cfg, shape)
        kind, spec = input_specs(acfg, shape)
        inputs = spec["batch"] if kind == "train" else {
            k: v for k, v in spec.items() if k in ("tokens", "patch_embeds")}
        got = shd.data_shardings(inputs, mesh)
        want = jshd.data_shardings(_sds(inputs), jmesh)
        assert {k: shd.spec_of(v, mesh) for k, v in got.items()} == \
            {k: trim(v.spec) for k, v in want.items()}, shape.name
        if "cache" in spec:
            _compare(shd.cache_shardings(spec["cache"], mesh, shape.batch),
                     jshd.cache_shardings(_sds(spec["cache"]), jmesh, shape.batch), mesh)


@pytest.mark.parametrize("arch", ["granite-34b", "deepseek-moe-16b"])
def test_fsdp_params_match_jax(arch):
    cfg = get_config(arch).replace(fsdp=True)
    jcfg = jax_get_config(arch).replace(fsdp=True)
    names, sizes = MESHES["16x16"]
    mesh = shd.MeshShape(names, sizes)
    params = model_lib.init_params(cfg, device="meta")
    specs = _compare(shd.params_shardings(params, mesh, cfg),
                     jshd.params_shardings(_sds(params), AbstractMesh(sizes, names), jcfg),
                     mesh)
    assert any("data" in s for s in specs.values())


def test_distribute_tree_on_meta_allocates_nothing():
    """Placing a meta tree needs no process group for its arithmetic:
    the local shapes are the global ones divided by the mesh."""
    names, sizes = MESHES["16x16"]
    mesh = shd.MeshShape(names, sizes)
    pls = shd.param_spec("units/b0/ffn/w_up", (36, 2048, 11008), mesh)
    assert shd._local_shape((36, 2048, 11008), pls, mesh) == (36, 2048, 688)
    t = {"units": {"b0": {"ffn": {"w_up": torch.empty(36, 2048, 11008, device="meta")}}}}
    sh = {"units": {"b0": {"ffn": {"w_up": pls}}}}
    assert shd.sharded_bytes(t, sh, mesh) == 36 * 2048 * 688 * 4
