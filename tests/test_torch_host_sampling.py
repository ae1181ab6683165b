"""Host sampling (``fuse_sampling=False``) and ``record_logits`` in the
port's gateway, on the CPU.

The fused mode and the host mode must give IDENTICAL tokens, greedy and
stochastic (temperature 0.8 with top_k 0, 5 and 50, several seeds), on
every route of the slot: the resident paged decode, the gather/scatter
decode, the contiguous pool, the bucket and the chunked prefill, a
prefix hit, and the compiled steps (the recording graph backend of
``test_torch_compiled.py``).  Both draw through one
``engine.sample_rows`` call on the device rows, with the same uniforms.
``record_logits`` keeps one row a token, held against the JAX
gateway's ``logits_rows`` on the same weights and stream (f32 smoke
weights; atol 1e-5: the two frameworks sum in different orders, 1.6e-6
apart at most on this stream), and the JAX package's own row-equality
checks run through the port (resident against gather/scatter, a prefix
hit against the cold prefill, chunked against bucket prefill at full
width; atol 1e-5 as there).  A preempted request draws its sampled
tokens again with its rows, and a ``FleetGateway`` slot takes both
arguments.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.licensing import LicenseTier as JaxLicenseTier
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.models import init_params as jax_init_params
from repro.serving import LicensedGateway as JaxGateway

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.models.model import params_from_jax
from repro_torch.serving import LicensedGateway, RequestState
from repro_torch.serving.compiled import DecodeGraphs, PrefillGraphs
from test_torch_compiled import Recorder
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MASKS = {"free": {"*": ((0.0, 0.004),)}, "pro": {"*": ((0.0, 0.001),)}}
GEOMETRY = dict(max_batch=3, max_prompt=12, max_new_cap=6, block_size=4)
ROW_TOL = dict(atol=1e-5, rtol=0)        # the JAX package's own row checks
JAX_ROW_TOL = dict(atol=1e-5, rtol=0)    # the port's rows against the JAX gateway's


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    return jcfg, jparams, cfg, params_from_jax(jax_flatten_params(jparams), device="cpu")


def _gateway(weights, **kw):
    cfg, params = weights[2], weights[3]
    kw = {**GEOMETRY, **kw}
    return LicensedGateway(cfg, params, device="cpu",
                           tiers={n: LicenseTier(name=n, masks=m) for n, m in MASKS.items()},
                           **kw)


def _prompt(i, n=None):
    rng = np.random.default_rng(200 + i)
    return rng.integers(0, 500, n or 3 + (i * 5) % 10, dtype=np.int32)


def _shared(i, head=8):
    """A shared 8-token system prompt with an own tail of 1-3 tokens."""
    sys_prompt = np.random.default_rng(7).integers(0, 500, head, dtype=np.int32)
    tail = np.random.default_rng(300 + i).integers(0, 500, 1 + i % 3, dtype=np.int32)
    return np.concatenate([sys_prompt, tail])


# greedy lanes and stochastic lanes: temperature 0.8, top_k 0, 5, 50
SAMPLING = [dict(), dict(temperature=0.8, top_k=0, seed=1), dict(temperature=0.8, top_k=5, seed=2),
            dict(), dict(temperature=0.8, top_k=50, seed=3), dict(temperature=0.8, top_k=5, seed=9)]
TIERS = ["full", "free", "pro", "free", "full", "pro"]


def _serve(gw, prompts, waves=1, **submit_kw):
    reqs, per = [], -(-len(prompts) // waves)
    for w in range(waves):
        reqs += [gw.submit(p, license=TIERS[i % len(TIERS)], max_new_tokens=3 + i % 3,
                           **{**SAMPLING[i % len(SAMPLING)], **submit_kw})
                 for i, p in enumerate(prompts[w * per:(w + 1) * per], start=w * per)]
        gw.run()
    assert all(r.state is RequestState.DONE for r in reqs), [r.error for r in reqs]
    return reqs


def _graphs(gw):
    backend = Recorder()
    gw._graphs = DecodeGraphs(gw.slot, backend=backend)
    gw._prefill_graphs = PrefillGraphs(gw.slot, backend=backend)
    return gw


ROUTES = {
    "resident": dict(prefix_cache=False),
    "gather_scatter": dict(prefix_cache=False, kernel_decode=False),
    "contiguous": dict(paged=False),
    "bucket": dict(prefix_cache=False, chunk_size=0),
    "chunked": dict(prefix_cache=False, chunk_size=3),
    "prefix_hit": dict(),
    "bucket_prefix_hit": dict(chunk_size=0),
    "graphs": dict(),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fused_and_host_tokens_identical(weights, route):
    shared = route in ("prefix_hit", "bucket_prefix_hit", "graphs")
    prompts = ([_shared(i) for i in range(6)] + [_shared(0)] if shared
               else [_prompt(i) for i in range(7)])
    runs = {}
    for name, kw in (("fused", {}), ("host", dict(fuse_sampling=False)),
                     ("recorded", dict(record_logits=True))):
        gw = _gateway(weights, **ROUTES[route], **kw)
        if route == "graphs":
            _graphs(gw)
        runs[name] = (gw, _serve(gw, prompts, waves=2 if shared else 1))
    toks = {k: [r.out_tokens for r in reqs] for k, (_, reqs) in runs.items()}
    assert toks["fused"] == toks["host"] == toks["recorded"]
    assert any(r.temperature > 0 and r.top_k == 0 for r in runs["host"][1])
    gw, reqs = runs["recorded"]
    assert not gw.fuse_sampling and not runs["host"][0].fuse_sampling
    for r in reqs:
        assert len(r.logits_rows) == len(r.out_tokens)
        if r.temperature == 0:
            assert [int(np.argmax(row)) for row in r.logits_rows] == r.out_tokens
    if shared and route != "graphs":
        assert gw.stats["prefix_tokens_reused"] > 0
    if route == "graphs":
        assert gw._graphs.replays > 0 and gw._prefill_graphs.captures > 0
    if route == "contiguous":
        assert not gw.paged


def test_sampled_tokens_reproduce_across_preemption(weights):
    """A preempted request restarts and draws its tokens again from the
    same (seed, index) generators, in the host mode as in the fused
    one; its recorded rows restart with it."""
    # test_torch_gateway.py's geometry: 9 blocks for three 5-block lanes
    small = dict(prefix_cache=False, max_batch=2, max_lanes=3, max_new_cap=8, num_blocks=9)

    def run(**kw):
        gw = _gateway(weights, **small, **kw)
        reqs = [gw.submit(_prompt(i, 12 - i), license=TIERS[i], max_new_tokens=6 + i % 3,
                          **SAMPLING[i]) for i in range(6)]
        gw.run()
        return gw, reqs

    _, want = run()
    gw, reqs = run(record_logits=True)
    assert gw.stats["preempted"] > 0
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in want]
    assert all(len(r.logits_rows) == len(r.out_tokens) for r in reqs)


def _jax_gateway(weights, **kw):
    jcfg, jparams = weights[0], weights[1]
    return JaxGateway(jcfg, jparams, telemetry=False,
                      tiers={n: JaxLicenseTier(name=n, masks=m) for n, m in MASKS.items()},
                      **{**GEOMETRY, **kw})


@pytest.mark.parametrize("route", ["chunked", "bucket"])
def test_logits_rows_match_jax(weights, route):
    """The same greedy mixed-tier stream through both gateways with
    ``record_logits``: identical tokens, one row a token, the rows within
    1e-5 of the JAX gateway's."""
    kw = dict(prefix_cache=False, record_logits=True,
              **({"chunk_size": 0} if route == "bucket" else {}))
    prompts = [_prompt(i) for i in range(6)]
    streams = []
    for gw in (_jax_gateway(weights, **kw), _gateway(weights, **kw)):
        reqs = [gw.submit(p, license=TIERS[i], max_new_tokens=3 + i % 3)
                for i, p in enumerate(prompts)]
        gw.run()
        streams.append(reqs)
    for jr, tr in zip(*streams):
        assert tr.out_tokens == jr.out_tokens
        assert len(tr.logits_rows) == len(jr.logits_rows) == tr.max_new_tokens
        for a, b in zip(tr.logits_rows, jr.logits_rows):
            np.testing.assert_allclose(a, np.asarray(b), **JAX_ROW_TOL)


def _rows_equal(a_reqs, b_reqs):
    for a, b in zip(a_reqs, b_reqs):
        assert a.out_tokens == b.out_tokens
        assert len(a.logits_rows) == len(b.logits_rows) == len(a.out_tokens)
        for ra, rb in zip(a.logits_rows, b.logits_rows):
            np.testing.assert_allclose(ra, rb, **ROW_TOL)


def _greedy(gw, prompts, waves=1):
    reqs, per = [], -(-len(prompts) // waves)
    for w in range(waves):
        reqs += [gw.submit(p, license=TIERS[i % len(TIERS)], max_new_tokens=2 + 2 * (i % 3))
                 for i, p in enumerate(prompts[w * per:(w + 1) * per], start=w * per)]
        gw.run()
    assert all(r.state is RequestState.DONE for r in reqs)
    return reqs


def test_resident_rows_match_gather_scatter(weights):
    """``test_paged_decode.py::test_resident_matches_gather_scatter_mixed_lengths``
    through the port."""
    prompts = [_prompt(i) for i in range(5)]
    base = _gateway(weights, kernel_decode=False, record_logits=True)
    resident = _gateway(weights, record_logits=True)
    _rows_equal(_greedy(base, prompts), _greedy(resident, prompts))
    assert base.stats["resident_decode_steps"] == 0
    assert resident.stats["resident_decode_steps"] == resident.stats["decode_steps"] > 0


def test_prefix_hit_rows_match_cold(weights):
    """``test_prefix.py::test_prefix_hits_match_cold_prefill_logits``
    through the port: a shared-prefix stream with an exact repeat."""
    prompts = [_shared(i) for i in range(6)] + [_shared(0)]
    cold = _gateway(weights, prefix_cache=False, record_logits=True)
    warm = _gateway(weights, record_logits=True)
    _rows_equal(_greedy(cold, prompts, waves=2), _greedy(warm, prompts, waves=2))
    assert warm.stats["prefix_tokens_reused"] > 0
    assert warm.stats["prefill_lane_tokens"] < cold.stats["prefill_lane_tokens"]


@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_chunked_rows_match_bucket_at_full_width(weights, chunk):
    """``test_chunked_prefill.py::test_gateway_chunked_matches_legacy_at_full_width``
    through the port: prompts of ``max_prompt`` tokens, where the bucket
    prefill serves the true tokens too."""
    prompts = [_prompt(40 + i, 12) for i in range(3)]
    a = _greedy(_gateway(weights, chunk_size=chunk, record_logits=True), prompts)
    b = _greedy(_gateway(weights, chunk_size=0, record_logits=True), prompts)
    _rows_equal(a, b)


def test_fleet_slots_take_the_sampling_arguments(weights):
    """``FleetGateway.add_model`` hands ``fuse_sampling`` and
    ``record_logits`` to its slot: a recording slot beside a fused one,
    both serving the same stream to the same tokens."""
    from repro_torch.serving import FleetGateway

    cfg, params = weights[2], weights[3]
    fleet = FleetGateway()
    tiers = {n: LicenseTier(name=n, masks=m) for n, m in MASKS.items()}
    fleet.add_model("fused", cfg, params, tiers=tiers, device="cpu", **GEOMETRY)
    fleet.add_model("recorded", cfg, params, tiers=tiers, device="cpu", record_logits=True,
                    **GEOMETRY)
    reqs = {m: [fleet.submit(m, _prompt(i), license=TIERS[i], max_new_tokens=3,
                             **SAMPLING[i]) for i in range(6)] for m in ("fused", "recorded")}
    fleet.run()
    assert [r.out_tokens for r in reqs["fused"]] == [r.out_tokens for r in reqs["recorded"]]
    assert all(r.logits_rows is None for r in reqs["fused"])
    assert all(len(r.logits_rows) == 3 for r in reqs["recorded"])
