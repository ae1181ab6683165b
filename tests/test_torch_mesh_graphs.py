"""The dry run's serving steps compiled (``repro_torch.serving.compiled.
MeshGraphs``) and the shard-local cache write, in one process on the
CPU.

On the card ``MeshGraphs`` captures ``prefill_step`` (with or without a
vision prefix) and ``serve_step`` (float, or in-scan from the int8
store) as CUDA graphs over DTensor weights and caches on a mesh, or over
plain tensors.  Here it takes ``_mesh_worker.GuardedRecorder``, whose
warm-ups, captures and replays run the step under a dispatch mode that
refuses every host-syncing op (the capture's refusal on the CPU).  The
sharded steps on a gloo world of 4 ranks are ``test_torch_mesh.py``'s.

* ``layers.write_local``, the sharded branch of ``write_at``, gives the
  bits of the boolean selection it replaced on local shards at every
  offset, hits and misses mixed, none hitting and all hitting; the guard
  refuses the boolean form and lets the new one through.
* On plain tensors: internvl2-26b's smoke variant (JAX weights with
  noisy norm scales, as ``test_torch_vlm.py``) through the
  patch-prefix prefill graph gives eager ``prefill_step(patch_embeds=)``'s
  logits bit for bit and the JAX ``prefill_step``'s within atol = rtol =
  1e-4; qwen2.5-3b's prefill and greedy decode steps through the graphs,
  float and in-scan, give the eager steps' tokens and logits bit for bit
  and the JAX steps' logits within 1e-4.
* The float tree's set and the int8 store's keep their own graphs,
  keys, counts and caches, and the in-scan set serves every tier from
  its one decode graph; a float tree refuses a tier's intervals, which
  it would not apply; a refused capture raises and leaves the cache
  pristine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.licensing import LicenseTier as JaxLicenseTier
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.models import init_params as jax_init_params
from repro.models import model as jax_model
from repro.serving import engine as jax_engine
from repro.serving.quantized import quantize_serving_params as jax_quantize
from repro.serving.quantized import tier_intervals as jax_tier_intervals

import _mesh_worker as W
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.core.pytree_io import flatten_params
from repro_torch.models import model
from repro_torch.models.layers import write_local
from repro_torch.serving import engine
from repro_torch.serving.compiled import MeshGraphs
from repro_torch.serving.quantized import quantize_serving_params, tier_intervals
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_engine_graphs import FailingCapture
from test_torch_layernorm import noisy_norms

TOL = dict(atol=1e-4, rtol=1e-4)
FREE = {"*": ((0.0, 0.004),)}
B, S, CAP, STEPS = 2, 6, 12, 3


def _boolean_write(local, idx, offsets, vals):
    """The sharded branch's write as it was: the entries in the shard
    picked by a boolean mask (a ``nonzero`` inside)."""
    hit = torch.ones(idx[0].shape, dtype=torch.bool)
    for i, o, size in zip(idx, offsets, local.shape):
        hit &= (i >= o) & (i < o + size)
    local[tuple(i[hit] - o for i, o in zip(idx, offsets))] = vals[hit]


# (local shard (lanes, slots), offsets, written lanes, slots a lane):
# a cache of 8 lanes x 16 slots cut over the lanes, the slots or both
SHARDS = {"lanes": ((4, 16), (4, 0), 4, 5), "slots": ((8, 8), (0, 8), 4, 6),
          "both": ((4, 8), (4, 8), 6, 9), "first_shard": ((2, 4), (0, 0), 8, 16),
          "none_hit": ((4, 8), (4, 8), 2, 3), "all_hit": ((8, 16), (0, 0), 8, 16),
          "one_slot": ((4, 8), (0, 8), 8, 1)}


def _write_case(name, seed):
    (lb, ls), offsets, b, s = SHARDS[name]
    g = torch.Generator().manual_seed(seed)
    rows = torch.randperm(8, generator=g)[:b]
    if name == "none_hit":
        rows = torch.arange(b)                  # lanes 0-1: the shard holds 4-7
    rows = rows[:, None].expand(b, s)
    slots = torch.stack([torch.randperm(16, generator=g)[:s] for _ in range(b)])
    vals = torch.randn(b, s, 2, 3, generator=g)
    local = torch.randn(lb, ls, 2, 3, generator=g)
    return local, (rows, slots), offsets, vals


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name", list(SHARDS))
def test_write_local_matches_boolean_form(name, seed):
    local, idx, offsets, vals = _write_case(name, seed)
    want, got = local.clone(), local.clone()
    _boolean_write(want, idx, offsets, vals)
    with W.HostSyncGuard():
        write_local(got, idx, offsets, vals)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if name == "none_hit":
        assert torch.equal(got.view(torch.int32), local.view(torch.int32))


def test_guard_refuses_the_boolean_form():
    local, idx, offsets, vals = _write_case("both", 0)
    with pytest.raises(RuntimeError, match="synchronizes with the host"):
        with W.HostSyncGuard():
            _boolean_write(local.clone(), idx, offsets, vals)
    for op in (lambda: torch.arange(4).nonzero(), lambda: torch.ones(1).item(),
               lambda: torch.arange(4).masked_select(torch.arange(4) > 1)):
        with pytest.raises(RuntimeError, match="synchronizes with the host"):
            with W.HostSyncGuard():
                op()


# ------------------------------------------------------------ plain tensors
@pytest.fixture(scope="module")
def vlm():
    jcfg = jax_smoke_variant(jax_get_config("internvl2-26b"))
    jparams, flat = noisy_norms(jax_init_params(jax.random.PRNGKey(0), jcfg), seed=1)
    cfg = smoke_variant(get_config("internvl2-26b"))
    return jcfg, jparams, cfg, model.params_from_jax(flat, device="cpu")


def test_vision_prefill_graph_matches_eager_and_jax(vlm):
    """Two prefills of one key: the first captures (its warm-up is the
    step), the second replays on new prompts and patches."""
    jcfg, jparams, cfg, params = vlm
    cap = cfg.num_patches + S + 2
    graphs = MeshGraphs(cfg, params, backend=W.GuardedRecorder())
    for seed in (4, 5):
        r = np.random.default_rng(seed)
        toks = r.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        patches = r.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(np.float32)
        got, greedy = graphs.prefill(toks, cap, patch_embeds=torch.from_numpy(patches))
        want, cache = engine.prefill_step(params, cfg, torch.from_numpy(toks),
                                          model.init_cache(cfg, B, cap, device="cpu"),
                                          patch_embeds=torch.from_numpy(patches))
        assert torch.equal(got, want)
        assert torch.equal(greedy, torch.argmax(want, -1).int())
        for path, leaf in flatten_params(graphs.caches[(B, cap)]).items():
            assert torch.equal(leaf, flatten_params(cache)[path]), path
        jwant, _ = jax_engine.prefill_step(jparams, jcfg, jnp.asarray(toks),
                                           jax_model.init_cache(jcfg, B, cap),
                                           patch_embeds=jnp.asarray(patches))
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **TOL)
    assert graphs.keys() == {("prefill", B, S, cap, cfg.num_patches)}
    assert (graphs.captures, graphs.replays) == (1, 1)


@pytest.fixture(scope="module")
def qwen():
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    params = model.params_from_jax(jax_flatten_params(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _prompts(cfg):
    return np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)


def _eager(cfg, params, li=None):
    """Prefill then STEPS greedy decode steps on plain tensors: (logits
    (STEPS + 1, B, V), tokens (STEPS, B))."""
    cache = model.init_cache(cfg, B, CAP, device="cpu")
    lg, cache = engine.prefill_step(params, cfg, torch.from_numpy(_prompts(cfg)), cache,
                                    license_intervals=li)
    logits, out = [lg], []
    for i in range(STEPS):
        nxt = torch.argmax(logits[-1], -1).int()
        out.append(nxt)
        lg, cache = engine.serve_step(params, cfg, nxt[:, None], cache,
                                      torch.full((B,), S + i, dtype=torch.int32), li)
        logits.append(lg)
    return torch.stack(logits), torch.stack(out)


def _graph(graphs, intervals=None):
    lg, greedy = graphs.prefill(_prompts(graphs.cfg), CAP, intervals=intervals)
    logits, out = [lg.clone()], []
    for i in range(STEPS):
        out.append(greedy.clone())
        lg, greedy = graphs.decode(greedy, S + i, CAP, intervals=intervals)
        logits.append(lg.clone())
    return torch.stack(logits), torch.stack(out)


def _jax_logits(jcfg, jparams, tokens, tier=None):
    """The JAX steps fed the port's greedy ``tokens`` (STEPS, B), in-scan
    with ``tier``'s intervals when one is given."""
    kw = {}
    if tier is not None:
        jparams = jax_quantize(jparams)
        kw = dict(license_intervals=jax_tier_intervals(tier))
    cache = jax_model.init_cache(jcfg, B, CAP)
    lg, cache = jax_engine.prefill_step(jparams, jcfg, jnp.asarray(_prompts(jcfg)), cache, **kw)
    want = [np.asarray(lg)]
    for i in range(STEPS):
        lg, cache = jax_engine.serve_step(jparams, jcfg, jnp.asarray(tokens[i][:, None]),
                                          cache, S + i, **kw)
        want.append(np.asarray(lg))
    return np.stack(want)


@pytest.mark.parametrize("mode", ["float", "in_scan"])
def test_plain_graphs_match_eager_and_jax(qwen, mode):
    jcfg, jparams, cfg, params = qwen
    li, tier = None, None
    if mode == "in_scan":
        params = quantize_serving_params(params)
        li = tier_intervals(LicenseTier(name="free", masks=FREE), device="cpu")
        tier = JaxLicenseTier(name="free", masks=FREE)
    graphs = MeshGraphs(cfg, params, backend=W.GuardedRecorder())
    assert graphs.in_scan == (mode == "in_scan") and graphs.device == torch.device("cpu")
    got_logits, got_tokens = _graph(graphs, li)
    want_logits, want_tokens = _eager(cfg, params, li)
    assert torch.equal(got_tokens, want_tokens)
    assert torch.equal(got_logits, want_logits)
    np.testing.assert_allclose(got_logits.numpy(),
                               _jax_logits(jcfg, jparams, got_tokens.numpy(), tier), **TOL)
    assert graphs.keys() == {("prefill", B, S, CAP, None), ("decode", B, CAP)}
    assert (graphs.captures, graphs.replays) == (2, STEPS)


def test_float_and_in_scan_sets_kept_apart(qwen):
    """Each set captures on its own weights and caches; the in-scan set's
    one decode graph serves the free tier and the full one (no
    intervals), reading the static intervals of each step."""
    _, _, cfg, params = qwen
    store = quantize_serving_params(params)
    li = tier_intervals(LicenseTier(name="free", masks=FREE), device="cpu")
    flt = MeshGraphs(cfg, params, backend=W.GuardedRecorder())
    q8 = MeshGraphs(cfg, store, backend=W.GuardedRecorder())
    f_logits, _ = _graph(flt)
    q_free, _ = _graph(q8, li)
    q_full, _ = _graph(q8)
    assert flt.keys() == q8.keys() == {("prefill", B, S, CAP, None), ("decode", B, CAP)}
    assert (flt.captures, flt.replays) == (2, STEPS)
    assert (q8.captures, q8.replays) == (2, 2 * STEPS + 1)
    assert flt.graphs[("decode", B, CAP)] is not q8.graphs[("decode", B, CAP)]
    ids = {id(t) for t in flatten_params(flt.caches[(B, CAP)]).values()}
    assert not ids & {id(t) for t in flatten_params(q8.caches[(B, CAP)]).values()}
    assert torch.equal(q_free, _eager(cfg, store, li)[0])
    assert torch.equal(q_full, _eager(cfg, store)[0])
    assert not torch.equal(q_free, q_full)
    assert not torch.equal(f_logits, q_full)      # the float tree, not the int8 store


@pytest.mark.parametrize("fail_at", [1, 2])
def test_refused_capture_leaves_cache_pristine(qwen, fail_at):
    """fail_at 1 refuses the prefill's capture (after its warm-up filled
    the cache): the cache is zeros again; 2 refuses the decode's (after
    its warm-up advanced the cache): the cache is the prefill's."""
    _, _, cfg, params = qwen
    graphs = MeshGraphs(cfg, params, backend=FailingCapture(fail_at))
    if fail_at == 2:
        _, greedy = graphs.prefill(_prompts(cfg), CAP)
    state = {k: t.clone() for k, t in flatten_params(graphs._cache(B, CAP)).items()}
    with pytest.raises(RuntimeError, match="capture refused"):
        if fail_at == 1:
            graphs.prefill(_prompts(cfg), CAP)
        else:
            graphs.decode(greedy, S, CAP)
    for path, leaf in flatten_params(graphs.caches[(B, CAP)]).items():
        assert torch.equal(leaf, state[path]), path
        if fail_at == 1:
            assert not leaf.any(), path
    assert graphs.captures == fail_at - 1 and not graphs.replays
    assert len(graphs.keys()) == fail_at - 1


def test_float_tree_refuses_intervals(qwen):
    """A tier's intervals given to the float tree's set raise before any
    capture: its steps would serve the unmasked weights."""
    _, _, cfg, params = qwen
    li = tier_intervals(LicenseTier(name="free", masks=FREE), device="cpu")
    graphs = MeshGraphs(cfg, params, backend=W.GuardedRecorder())
    assert not graphs.in_scan
    with pytest.raises(ValueError, match="no license intervals"):
        graphs.prefill(_prompts(cfg), CAP, intervals=li)
    _, greedy = graphs.prefill(_prompts(cfg), CAP)
    with pytest.raises(ValueError, match="no license intervals"):
        graphs.decode(greedy, S, CAP, intervals=li)
    assert graphs.keys() == {("prefill", B, S, CAP, None)} and graphs.captures == 1


def test_bf16_input_filled_from_the_device_only():
    """A static input whose dtype numpy lacks (the bf16 patch
    embeddings) takes a tensor and refuses host values."""
    from repro_torch.serving.compiled import _Input

    static = _Input((2, 3), torch.bfloat16, torch.device("cpu"))
    src = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    static.fill(src)
    assert torch.equal(static.dev, src)
    with pytest.raises(TypeError, match="filled from a tensor"):
        static.fill(np.zeros((2, 3), np.float32))
    ints = _Input((2,), torch.int32, torch.device("cpu"))
    ints.fill(np.array([3, 4]))
    assert ints.dev.tolist() == [3, 4]
