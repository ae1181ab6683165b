"""The port's ServingEngine against the JAX package's, on the CPU.

Both engines serve the same requests from the same f32 smoke weights of
qwen2.5-3b (carried across with ``params_from_jax``): every case of
``tests/test_serving.py`` runs through both, and their greedy tokens
must be IDENTICAL, float and ``quantized=True`` (the int8 store with
the tier's intervals dequantized in every step), as must the
counterpart of ``tests/test_end_to_end.py::
test_licensed_lm_serving_both_modes``.  The port's own checks: the
device refusal, ``gateway()``'s refusal and its tokens, and the host
sampler (``engine.sample``) against its definition.  The small helpers
of the serving package (``GatewayRequest.ttft``,
``Scheduler.free_lanes()``, ``telemetry.dump_json``) are held against
the JAX gateway's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.licensing import LicenseTier as JaxLicenseTier
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.models import init_params as jax_init_params
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.core.pytree_io import flatten_params
from repro_torch.models.model import params_from_jax
from repro_torch.serving import Request, ServingEngine, sample
from repro_torch.serving.engine import sample_rows
from repro_torch.serving.quantized import is_qleaf
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FREE = {"*": ((0.0, 0.004),)}


def _weights(**replace):
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b")).replace(**replace)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config("qwen2.5-3b")).replace(**replace)
    return jcfg, jparams, cfg, params_from_jax(jax_flatten_params(jparams), device="cpu")


def _engines(weights, masks=FREE, **kw):
    jcfg, jparams, cfg, params = weights
    jeng = JaxEngine(jcfg, jparams, tiers={"free": JaxLicenseTier(name="free", masks=masks)},
                     **kw)
    teng = ServingEngine(cfg, params, tiers={"free": LicenseTier(name="free", masks=masks)},
                         device="cpu", **kw)
    return jeng, teng


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(scope="module")
def engines(weights):
    return _engines(weights)


def _prompt(seed, n=16):
    return np.random.default_rng(seed).integers(0, 500, n, dtype=np.int32)


def _both(engines, specs, **kw):
    """Serve ``specs`` (seed, max_new_tokens, license) through both
    engines; returns (JAX tokens, port tokens)."""
    jeng, teng = engines
    jreqs = [JaxRequest(prompt=_prompt(s), max_new_tokens=n, license=lic)
             for s, n, lic in specs]
    treqs = [Request(prompt=_prompt(s), max_new_tokens=n, license=lic)
             for s, n, lic in specs]
    jeng.generate(jreqs, **kw)
    teng.generate(treqs, **kw)
    return [r.out_tokens for r in jreqs], [r.out_tokens for r in treqs]


def test_generate_fills_requested_tokens(engines):
    want, got = _both(engines, [(0, 6, "full"), (1, 4, "full")])
    assert [len(t) for t in got] == [6, 4]
    assert all(0 <= t < engines[1].cfg.padded_vocab for toks in got for t in toks)
    assert got == want


def test_greedy_decode_deterministic(engines):
    _, teng = engines
    a, b = Request(prompt=_prompt(3)), Request(prompt=_prompt(3))
    teng.generate([a])
    teng.generate([b])
    assert a.out_tokens == b.out_tokens and len(a.out_tokens) == 16
    want, got = _both(engines, [(3, 16, "full")])
    assert got == want == [a.out_tokens]


def test_licensed_view_differs_and_is_cached(engines):
    jeng, teng = engines
    full, free1, free2 = (teng.params_for(n) for n in ("full", "free", "free"))
    assert free1 is free2                      # cached view
    assert full is teng.base_params            # the full tier masks nothing
    ffull, ffree = flatten_params(full), flatten_params(free1)
    assert any(not torch.equal(ffull[k], ffree[k]) for k in ffull)
    # the same masks as the JAX engine's view, leaf for leaf
    jfree = jax_flatten_params(jeng.params_for("free"))
    for k, v in ffree.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jfree[k]))


def test_mixed_tier_batch_grouped(engines):
    want, got = _both(engines, [(0, 6, "full"), (0, 6, "free"), (5, 3, "free")])
    assert [len(t) for t in got] == [6, 6, 3]
    assert got == want


def test_unknown_tier_raises(engines):
    with pytest.raises(KeyError):
        engines[1].params_for("enterprise")


def test_quantized_engine_one_store_many_tiers(weights):
    jeng, teng = _engines(weights, quantized=True)
    # the same object serves both tiers: zero extra weight memory
    assert teng.params_for("full") is teng.params_for("free") is teng.base_params
    assert teng.intervals_for("full") is None
    lo, hi = teng.intervals_for("free")
    np.testing.assert_array_equal(np.stack([lo.numpy(), hi.numpy()]),
                                  np.stack([np.asarray(x) for x in jeng.intervals_for("free")]))
    assert any(is_qleaf(v) for v in teng.base_params["units"]["b0"]["ffn"].values())
    want, got = _both((jeng, teng), [(0, 6, "full"), (0, 6, "free"), (7, 4, "free")])
    assert [len(t) for t in got] == [6, 6, 4]
    assert got == want


def test_licensed_lm_serving_both_modes():
    """Counterpart of the end-to-end test's serving step (vocab 256, a
    12-token prompt, 4 new tokens, a tier masking |w| < 0.002): the
    paper's mask-at-load engine and the int8 engine, each through both
    packages, at random weights (the JAX test's are trained)."""
    w = _weights(vocab_size=256)
    masks = {"*": ((0.0, 0.002),)}
    for kw in ({}, dict(quantized=True)):
        jeng, teng = _engines(w, masks=masks, **kw)
        prompt = np.arange(12, dtype=np.int32)
        a = jeng.generate([JaxRequest(prompt=prompt, max_new_tokens=4)])[0]
        b = teng.generate([Request(prompt=prompt, max_new_tokens=4)])[0]
        assert len(b.out_tokens) == 4
        assert all(0 <= t < w[2].padded_vocab for t in b.out_tokens)
        assert b.out_tokens == a.out_tokens, kw


def test_engine_refuses_params_elsewhere(weights):
    """The engine runs where its params live: the card by default, the
    CPU only when asked for."""
    _, _, cfg, params = weights
    with pytest.raises(ValueError, match="params live on cpu"):
        ServingEngine(cfg, params)
    with pytest.raises(ValueError, match="params live on cpu"):
        ServingEngine(cfg, params, device="meta")
    assert ServingEngine(cfg, params, device="cpu").device.type == "cpu"


def test_gateway_mirrors_the_engine(engines):
    """``gateway()`` refuses a weight-store mode of its own, and serves
    the engine's weights, tiers and device to the engine's greedy
    tokens."""
    _, teng = engines
    for kw in (dict(quantized=True), dict(already_quantized=False)):
        with pytest.raises(ValueError, match="mirrors the engine's quantization"):
            teng.gateway(**kw)
    gw = teng.gateway(max_batch=2, max_prompt=16, max_new_cap=6, block_size=4)
    assert gw.device.type == "cpu" and set(gw.tiers) == {"full", "free"}
    specs = [(0, 6, "full"), (0, 6, "free"), (5, 3, "free")]
    reqs = [gw.submit(_prompt(s), license=lic, max_new_tokens=n) for s, n, lic in specs]
    gw.run()
    _, got = _both(engines, specs)
    assert [r.out_tokens for r in reqs] == got


def test_sampled_generation_is_seeded(engines):
    _, teng = engines

    def run(seed):
        reqs = [Request(prompt=_prompt(i), max_new_tokens=5, temperature=0.9)
                for i in range(3)]
        teng.generate(reqs, seed=seed)
        return [r.out_tokens for r in reqs]

    assert run(4) == run(4)
    assert all(0 <= t < teng.cfg.vocab_size for toks in run(5) for t in toks)


def test_sample_is_its_definition():
    """Greedy is the first argmax; a draw follows softmax(logits / T)
    over the top-k logits (their empirical frequencies within 0.02 over
    4,000 draws), reproducibly per generator; a draw is one uniform a
    row from the generator through ``sample_rows``, on the logits'
    device."""
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5, 2.0]])
    assert sample(logits, temperature=0.0).tolist() == [1]
    assert sample(logits[0], temperature=0.0).item() == 1
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([sample(logits[0], gen, temperature=0.7, top_k=3)
                         for _ in range(4000)])
    assert set(draws.tolist()) <= {1, 2, 4}
    keep = torch.tensor([False, True, True, False, True])
    want = torch.softmax(torch.where(keep, logits[0] / 0.7, -torch.inf), -1)
    freq = torch.bincount(draws.long(), minlength=5).float() / len(draws)
    assert torch.allclose(freq, want, atol=0.02)
    one = torch.Generator().manual_seed(3)
    two = torch.Generator().manual_seed(3)
    batch = logits.repeat(4, 1)
    assert torch.equal(sample(batch, one, temperature=1.0), sample(batch, two, temperature=1.0))
    # no draw lands on a logit of probability 0 past the last live one
    tail = torch.tensor([[0.5, 2.0, -torch.inf, -torch.inf]]).repeat(500, 1)
    assert set(sample(tail, gen, temperature=1.0).tolist()) == {0, 1}
    knobs = dict(temperature=0.7, top_k=3)
    drawn = sample(batch, torch.Generator().manual_seed(5), **knobs)
    u = torch.rand(4, generator=torch.Generator().manual_seed(5)).tolist()
    assert torch.equal(drawn, sample_rows(batch, u, [0.7] * 4, [3] * 4))
    assert sample(logits.to("meta"), gen, temperature=1.0).device.type == "meta"


def test_sample_rows_draws_each_row_on_its_own():
    """A batch of rows at mixed temperatures and top-k (0 = off) draws
    each row's token as that row drawn alone with the same uniform: the
    gateway's batched draw of its sampling lanes gives a lane the token
    its own row, uniform, temperature and k decide."""
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.normal(size=(6, 97)).astype(np.float32))
    u = rng.random(6).astype(np.float32).tolist()
    temps, ks = [0.8, 1.3, 0.8, 0.5, 2.0, 0.8], [0, 5, 50, 1, 0, 200]
    batch = sample_rows(rows, u, temps, ks)
    alone = torch.cat([sample_rows(rows[i:i + 1], u[i:i + 1], temps[i:i + 1], ks[i:i + 1])
                       for i in range(6)])
    assert torch.equal(batch, alone)
    assert batch[3].item() == torch.argmax(rows[3]).item()       # top-1 is greedy
    top5 = torch.topk(rows[1], 5).indices.tolist()
    assert batch[1].item() in top5


def test_small_helpers_match_jax(weights):
    """``GatewayRequest.ttft``, ``Scheduler.free_lanes()`` (a method, as
    in the JAX package) and ``telemetry.dump_json``, beside the JAX
    gateway's on one stream with a hand-advanced clock."""
    from repro.serving import LicensedGateway as JaxGateway
    from repro.serving.telemetry import dump_json as jax_dump_json

    from repro_torch.serving import LicensedGateway
    from repro_torch.serving.telemetry import dump_json

    jcfg, jparams, cfg, params = weights
    geometry = dict(max_batch=2, max_lanes=3, max_prompt=16, max_new_cap=4, block_size=4,
                    prefix_cache=False)
    out = []
    for gw_cls, p, kw in ((JaxGateway, jparams, {}), (LicensedGateway, params, {"device": "cpu"})):
        now = [0.0]

        def clock():
            now[0] += 0.25
            return now[0]

        gw = gw_cls(cfg if gw_cls is LicensedGateway else jcfg, p, clock=clock, **geometry, **kw)
        assert gw.scheduler.free_lanes() == 3
        reqs = [gw.submit(_prompt(i, 5 + i), max_new_tokens=3) for i in range(3)]
        assert reqs[0].ttft is None
        gw.step()
        lanes_busy = gw.scheduler.free_lanes()
        gw.run()
        out.append(([r.ttft for r in reqs], lanes_busy, gw.scheduler.free_lanes(),
                    [r.out_tokens for r in reqs]))
        stats = dict(gw.stats)
        assert dump_json(stats) == jax_dump_json(stats)
    assert out[0] == out[1]
    assert all(t > 0 for t in out[1][0]) and out[1][1] == 1 and out[1][2] == 3
