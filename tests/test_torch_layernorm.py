"""LayerNorm, ``norm_bf16_apply`` and musicgen-large in the port, against
the JAX package, on the CPU.

* ``layers.layer_norm`` and ``layers.apply_norm`` (LayerNorm with a
  ``bias``; RMS applied in f32 or, with ``norm_bf16_apply``, in the input
  dtype) in f32 and bf16;
* ``norm_bf16_apply=True`` on the qwen2.5-3b smoke variant in bf16: the
  logits move, towards the JAX package's;
* musicgen-large's smoke variant (LayerNorm, MHA 4/4 at head dim 64,
  codec vocabulary): config fields, logits, prefill then decode, the
  paged decode on both routes, ``lm_loss`` with its gradients, the
  in-scan int8 forward, and the gateway's greedy tokens per tier on float
  and int8 views against the JAX gateway.

Both packages initialize norm scales to ones and biases to zeros, which
would hide a missing bias or a wrong variance, so every ``norm_scale`` and
norm ``bias`` gets numpy noise before the weights are carried across
(``params_from_jax``).  f32 logits at atol = rtol = 1e-4
(``test_torch_model.py``), gradients at the training path's rtol 1e-4 and
atol 1e-6; bf16 at ``tests/test_kernels.py``'s bf16 tolerance, 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.licensing import LicenseTier as JaxLicenseTier
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.core.pytree_io import unflatten_like as jax_unflatten_like
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.serving import LicensedGateway as JaxGateway
from repro.serving.engine import serve_step_paged as jax_serve_step_paged
from repro.serving.quantized import quantize_serving_params as jax_quantize
from repro.serving.quantized import tier_intervals as jax_tier_intervals

from repro_torch.configs import ModelConfig, get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier, apply_license
from repro_torch.core.pytree_io import flatten_params
from repro_torch.models import layers, model
from repro_torch.serving import LicensedGateway, RequestState
from repro_torch.serving import quantized
from repro_torch.serving.engine import serve_step_paged
from repro_torch.training.train_lib import _value_and_grad
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
FREE = {"*": ((0.0, 0.01),)}
GEOMETRY = dict(max_batch=2, max_lanes=3, max_prompt=12, max_new_cap=8,
                block_size=4, num_blocks=9)
STREAM = [("full", 7), ("free", 5), ("full", 11), ("free", 9), ("full", 3), ("free", 10)]


def noisy_norms(jparams, seed=0):
    """``jparams`` with numpy noise on every norm scale and norm bias:
    (the JAX tree, its flat numpy dict for ``params_from_jax``)."""
    r = np.random.default_rng(seed)
    flat = jax_flatten_params(jparams)
    for name, a in flat.items():
        last = name.rsplit("/", 1)[-1]
        if last == "norm_scale" or (last == "bias" and "norm" in name):
            noise = r.standard_normal(a.shape) * 0.3
            flat[name] = (a.astype(np.float32) * (1 + noise) if last == "norm_scale"
                          else a.astype(np.float32) + noise).astype(a.dtype)
    return jax.tree_util.tree_map(jnp.asarray, jax_unflatten_like(jparams, flat)), flat


def _tokens(seed, shape, high=500):
    return np.random.default_rng(seed).integers(0, high, shape, dtype=np.int32)


def _torch(a, dtype):
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    return t.to(getattr(torch, dtype))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_apply_norm_match_jax(dtype):
    """LayerNorm's population variance and eps 1e-5, and ``apply_norm``'s
    three branches, on the same inputs in both packages (a numpy
    LayerNorm with ``ddof=0`` as a third witness in f32)."""
    r = np.random.default_rng(1)
    x = jnp.asarray(r.standard_normal((2, 5, 64)) * 3 + 1, jnp.float32).astype(dtype)
    scale = jnp.asarray(1 + 0.3 * r.standard_normal(64), jnp.float32).astype(dtype)
    bias = jnp.asarray(0.3 * r.standard_normal(64), jnp.float32).astype(dtype)
    tx, ts, tb = (_torch(a, dtype) for a in (x, scale, bias))
    tol = TOL if dtype == "float32" else BF16_TOL
    got = layers.layer_norm(tx, ts, tb)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), np.asarray(jax_layers.layer_norm(x, scale, bias)
                                                    .astype(jnp.float32)), **tol)
    if dtype == "float32":
        xn = np.asarray(x, np.float64)
        want = ((xn - xn.mean(-1, keepdims=True)) / np.sqrt(xn.var(-1, ddof=0, keepdims=True)
                                                            + 1e-5) * np.asarray(scale)
                + np.asarray(bias))
        np.testing.assert_allclose(_np(got), want, **TOL)
    on = get_config("qwen2.5-3b").replace(norm_bf16_apply=True)
    jon = jax_get_config("qwen2.5-3b").replace(norm_bf16_apply=True)
    for p, jp, cfg, jcfg in (({"norm_scale": ts, "bias": tb}, {"norm_scale": scale, "bias": bias},
                              None, None),
                             ({"norm_scale": ts}, {"norm_scale": scale}, None, None),
                             ({"norm_scale": ts}, {"norm_scale": scale}, on, jon)):
        want = np.asarray(jax_layers.apply_norm(x, jp, jcfg).astype(jnp.float32))
        np.testing.assert_allclose(_np(layers.apply_norm(tx, p, cfg)), want, **tol)


def test_norm_bf16_apply_moves_bf16_logits_to_jax():
    """qwen2.5-3b smoke in bf16 with ``norm_bf16_apply``: the port's
    logits change against the flag off, lie within the bf16 tolerance of
    the JAX package's, and closer to them than the flag-off logits are."""
    name = "qwen2.5-3b"
    jcfg = jax_smoke_variant(jax_get_config(name)).replace(dtype_name="bfloat16",
                                                          norm_bf16_apply=True)
    cfg = smoke_variant(get_config(name)).replace(dtype_name="bfloat16", norm_bf16_apply=True)
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                     jax_init_params(jax.random.PRNGKey(0), jcfg))
    jparams, flat = noisy_norms(jparams, seed=2)
    params = model.params_from_jax(flat, device="cpu")
    toks = _tokens(3, (2, 9))
    want = np.asarray(jax_model.forward(jparams, jcfg, jnp.asarray(toks))[0])
    on, _ = model.forward(params, cfg, torch.from_numpy(toks))
    off, _ = model.forward(params, cfg.replace(norm_bf16_apply=False), torch.from_numpy(toks))
    assert not torch.equal(on, off)
    np.testing.assert_allclose(on.numpy(), want, **BF16_TOL)
    err_on = np.abs(on.numpy() - want).max()
    err_off = np.abs(off.numpy() - want).max()
    assert err_on < err_off, (err_on, err_off)


# ------------------------------------------------------------- musicgen-large
@pytest.fixture(scope="module")
def musicgen():
    name = "musicgen-large"
    jcfg = jax_smoke_variant(jax_get_config(name))
    jparams, flat = noisy_norms(jax_init_params(jax.random.PRNGKey(0), jcfg))
    cfg = smoke_variant(get_config(name))
    return jcfg, jparams, cfg, model.params_from_jax(flat, device="cpu")


def test_musicgen_config_and_leaves(musicgen):
    """Every field of the full config and its smoke variant equals the
    JAX package's; ``check_supported`` takes the "audio" front end; every
    norm has a ``bias`` beside its scale, stacked (U, D) in a unit; the
    port's own ``init_params`` draws the same tree."""
    jcfg, jparams, cfg, params = musicgen
    for got, want in ((get_config("musicgen-large"), jax_get_config("musicgen-large")),
                      (cfg, jcfg)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        model.check_supported(got)
    assert cfg.norm_layernorm and cfg.frontend == "audio"
    u, d = cfg.pattern_units, cfg.d_model
    for norm in ("norm1", "norm2"):
        assert tuple(params["units"]["b0"][norm]["bias"].shape) == (u, d)
    assert tuple(params["final_norm"]["bias"].shape) == (d,)
    own = model.init_params(cfg, seed=0, device="cpu")
    assert ({n: tuple(t.shape) for n, t in flatten_params(own).items()}
            == {n: tuple(t.shape) for n, t in flatten_params(params).items()})
    assert not own["final_norm"]["bias"].any()


def test_musicgen_one_shot_prefill(musicgen):
    jcfg, jparams, cfg, params = musicgen
    toks = _tokens(4, (2, 9))
    want, _, _ = jax_model.forward(jparams, jcfg, jnp.asarray(toks))
    got, _ = model.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_musicgen_prefill_then_decode(musicgen):
    jcfg, jparams, cfg, params = musicgen
    toks, cap = _tokens(5, (2, 6)), 10
    jcache = jax_model.init_cache(jcfg, 2, cap)
    _, _, jcache = jax_model.forward(jparams, jcfg, jnp.asarray(toks), cache=jcache)
    cache = model.init_cache(cfg, 2, cap, device="cpu")
    model.forward(params, cfg, torch.from_numpy(toks), cache=cache)
    for step in range(2):
        nxt = _tokens(6 + step, (2, 1))
        want, _, jcache = jax_model.forward(jparams, jcfg, jnp.asarray(nxt), cache=jcache,
                                            pos=6 + step)
        got, cache = model.forward(params, cfg, torch.from_numpy(nxt), cache=cache,
                                   pos=6 + step)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache["units"]["b0"][key].numpy(),
                                   np.asarray(jcache["units"]["b0"][key]), **TOL)


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_musicgen_paged_decode(musicgen, route):
    """A decode step against a random pool, 3 live lanes and a pad lane:
    the plain route against ``kernel="off"``, the kernel route (the plain
    versions on the CPU) against the Pallas kernels in interpret mode, at
    a group of 1 and head dim 64."""
    jcfg, jparams, cfg, params = musicgen
    r = np.random.default_rng(8)
    u, kh, hd, bs, p = cfg.pattern_units, cfg.num_kv_heads, cfg.head_dim, 4, 12
    pools = {n: r.standard_normal((u, p + 1, bs, kh, hd)).astype(np.float32)
             for n in ("k", "v")}
    pos = np.asarray([5, 13, 2, 0], np.int32)
    tables = np.full((4, 4), p, np.int32)
    perm = r.permutation(p)
    tables[0, :2], tables[1, :4], tables[2, :1] = perm[:2], perm[2:6], perm[6:7]
    toks = r.integers(0, 500, (4, 1)).astype(np.int32)
    jcache = {"units": {"b0": {**{n: jnp.asarray(t)[:, None] for n, t in pools.items()},
                               "len": jnp.zeros((u, 4), jnp.int32)}}}
    want, _ = jax_serve_step_paged(jparams, jcfg, jnp.asarray(toks), jcache,
                                   jnp.asarray(tables), jnp.asarray(pos),
                                   kernel="off" if route == "plain" else "interpret")
    cache = {"units": {"b0": {**{n: torch.from_numpy(t.copy()) for n, t in pools.items()},
                              "len": torch.zeros((u, 4), dtype=torch.int32)}}}
    got, _ = serve_step_paged(params, cfg, torch.from_numpy(toks), cache,
                              torch.from_numpy(tables), torch.from_numpy(pos),
                              kernel=route == "kernel")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_musicgen_lm_loss_and_grads(musicgen):
    """``lm_loss`` and its gradients, norm scales and biases included."""
    from repro_torch.core.pytree_io import flatten_params as port_flatten

    jcfg, jparams, cfg, params = musicgen
    toks = _tokens(9, (2, 8))
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -100, np.int32)], axis=1)

    def jax_loss(p):
        return jax_model.lm_loss(p, jcfg, jnp.asarray(toks), jnp.asarray(labels))

    (jl, _), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jparams)
    (got, _), grads = _value_and_grad(
        lambda p: model.lm_loss(p, cfg, torch.from_numpy(toks), torch.from_numpy(labels)),
        params)
    np.testing.assert_allclose(float(got), float(jl), rtol=1e-5)
    want, grads = jax_flatten_params(jgrads), port_flatten(grads)
    assert list(grads) == list(want)
    assert "units/b0/norm1/bias" in grads and "final_norm/bias" in grads
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_musicgen_in_scan_int8_and_license(musicgen):
    """The int8 store keeps the norm biases float (as the JAX package's
    ``_eligible`` does), the in-scan forward in the free tier matches JAX
    on its own store, and ``apply_license`` leaves the norm biases as they
    are (the "norm" dynamics keyword)."""
    jcfg, jparams, cfg, params = musicgen
    lt = LicenseTier(name="free", masks=FREE)
    store = quantized.quantize_serving_params(params)
    jstore = jax_quantize(jparams)
    for s in (store, jstore):
        assert not isinstance(s["units"]["b0"]["norm1"]["bias"], dict)
        assert not isinstance(s["final_norm"]["bias"], dict)
    assert len(list(quantized.qleaves(store["units"]))) == 7
    toks = _tokens(10, (2, 9))
    want, _, _ = jax_model.forward(
        jstore, jcfg, jnp.asarray(toks),
        license_intervals=jax_tier_intervals(JaxLicenseTier(name="free", masks=FREE)))
    got, _ = model.forward(store, cfg, torch.from_numpy(toks),
                           license_intervals=quantized.tier_intervals(lt, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    view = apply_license(params, lt)
    for norm in ("norm1", "norm2"):
        assert view["units"]["b0"][norm]["bias"] is params["units"]["b0"][norm]["bias"]
    assert not torch.equal(view["units"]["b0"]["mixer"]["wq"], params["units"]["b0"]["mixer"]["wq"])


def _prompt(i, n, high):
    return np.random.default_rng(100 + i).integers(0, high, n, dtype=np.int32)


def gateway_streams(jcfg, jparams, cfg, params, mode):
    """A mixed-tier greedy stream through the JAX gateway and the port's
    (prefix cache off), on float views or on materialized int8 views:
    (JAX requests, port requests, JAX gateway, port gateway)."""
    views = {} if mode == "float" else dict(quantized=True, materialize_int8_views=True)
    jgw = JaxGateway(jcfg, jparams, tiers={"free": JaxLicenseTier(name="free", masks=FREE)},
                     prefix_cache=False, telemetry=False, **GEOMETRY, **views)
    gw = LicensedGateway(cfg, params, tiers={"free": LicenseTier(name="free", masks=FREE)},
                         prefix_cache=False, device="cpu", **GEOMETRY, **views)
    out = []
    for g in (jgw, gw):
        reqs = [g.submit(_prompt(i, n, cfg.vocab_size), license=tier, max_new_tokens=6 + i % 3)
                for i, (tier, n) in enumerate(STREAM)]
        g.run()
        out.append(reqs)
    assert all(r.state is RequestState.DONE for r in out[1])
    return out[0], out[1], jgw, gw


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_musicgen_gateway_tokens_match_jax(musicgen, mode):
    jreqs, reqs, jgw, gw = gateway_streams(*musicgen, mode)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert list(gw.trace) == list(jgw.trace)
    assert gw.stats["preempted"] == jgw.stats["preempted"] > 0


def test_port_config_dataclass_takes_every_jax_config():
    """``check_supported`` accepts every config the JAX package registers
    for the assigned pool, as the port's dataclass."""
    from repro.configs import ASSIGNED_ARCHS

    for name in ASSIGNED_ARCHS:
        cfg = ModelConfig(**dataclasses.asdict(jax_get_config(name)))
        model.check_supported(cfg)
        assert cfg == get_config(name)


def launcher_matches_jax(arch, tmp_path, capsys):
    """``--arch arch --store PATH`` through both packages' launchers at
    smoke size: the same version line and greedy tokens in every tier."""
    from repro.core.weightstore import WeightStore as JaxWeightStore
    from repro.launch import serve as jax_serve

    from repro_torch.launch import serve
    from test_torch_launch import ARGS, _served

    cfg = jax_smoke_variant(jax_get_config(arch))
    path = str(tmp_path / "store.db")
    store = JaxWeightStore(path)
    for seed in (0, 1):
        store.commit(cfg.name, jax_init_params(jax.random.PRNGKey(seed), cfg))
    store.close()
    args = ["--arch", arch, *ARGS[2:], "--store", path]
    jax_serve.main(args)
    want = _served(capsys.readouterr().out)
    serve.main([*args, "--device", "cpu"])
    got = _served(capsys.readouterr().out)
    assert want[0] == ["loaded production version 2"] and len(want[1]) == 2
    assert got == want


def test_musicgen_launcher_matches_jax(tmp_path, capsys):
    launcher_matches_jax("musicgen-large", tmp_path, capsys)
