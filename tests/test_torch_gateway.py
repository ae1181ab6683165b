"""The port's LicensedGateway against the JAX gateway, on the CPU.

One mixed-tier greedy request stream goes through
``repro.serving.LicensedGateway(prefix_cache=False, telemetry=False)``
and through ``repro_torch.serving.LicensedGateway(prefix_cache=False)``
on the same weights
(carried across with ``params_from_jax``), in both view modes: float
(``apply_license``) and the int8 store with materialized views (the
fused masked-dequant).  Prompt lengths are not block multiples and the
pool is small enough to force preemption.  Greedy tokens must be
IDENTICAL, and so must the scheduler's action sequence and counters —
the two frameworks sum logits in different orders (~1e-6 apart in f32),
which moves no argmax at these weights.

Sampled tokens are not compared: the port draws from torch.Generators,
the JAX gateway from ``jax.random`` keys.
"""
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.licensing import LicenseTier as JaxLicenseTier
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.models import init_params as jax_init_params
from repro.serving import LicensedGateway as JaxGateway
from repro.serving.fleet import ModelSlot as JaxModelSlot
from repro.serving.paging import BlockAllocator as JaxBlockAllocator
from repro.serving.quantized import quantize_serving_params as jax_quantize_serving_params

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.licensing import LicenseTier
from repro_torch.models.model import params_from_jax
from repro_torch.serving import BlockAllocator, LicensedGateway, RequestState
from repro_torch.serving.fleet import _LEFT_OUT
from repro_torch.serving.quantized import quantize_serving_params

ROADMAP = Path(__file__).resolve().parents[1] / "ROADMAP.md"

FREE = {"*": ((0.0, 0.01),)}
# mixed tiers, prompt lengths off block multiples (block_size 4)
STREAM = [("full", 7), ("free", 5), ("full", 11), ("free", 9),
          ("full", 3), ("free", 10)]
GEOMETRY = dict(max_batch=2, max_lanes=3, max_prompt=12, max_new_cap=8,
                block_size=4, num_blocks=9)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    params = params_from_jax(jax_flatten_params(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _prompt(i, n):
    return np.random.default_rng(100 + i).integers(0, 500, n, dtype=np.int32)


def _drain(gw):
    reqs = [gw.submit(_prompt(i, n), license=tier, max_new_tokens=6 + i % 3)
            for i, (tier, n) in enumerate(STREAM)]
    gw.run()
    return reqs


@pytest.fixture(scope="module", params=["float", "int8", "int8_already_quantized"])
def streams(request, weights):
    """``int8_already_quantized``: each gateway is handed its package's
    int8 store of the same weights (``already_quantized=True``)."""
    jcfg, jparams, cfg, params = weights
    mode = ({} if request.param == "float"
            else dict(quantized=True, materialize_int8_views=True))
    if request.param == "int8_already_quantized":
        jparams = jax_quantize_serving_params(jparams)
        params = quantize_serving_params(params)
        mode = dict(already_quantized=True, materialize_int8_views=True)
    jgw = JaxGateway(jcfg, jparams,
                     tiers={"free": JaxLicenseTier(name="free", masks=FREE)},
                     prefix_cache=False, telemetry=False, **GEOMETRY, **mode)
    tgw = LicensedGateway(cfg, params,
                          tiers={"free": LicenseTier(name="free", masks=FREE)},
                          prefix_cache=False, device="cpu", **GEOMETRY, **mode)
    return jgw, _drain(jgw), tgw, _drain(tgw)


def test_greedy_tokens_identical(streams):
    jgw, jreqs, tgw, treqs = streams
    assert all(r.state is RequestState.DONE for r in treqs)
    for jr, tr in zip(jreqs, treqs):
        assert tr.out_tokens == jr.out_tokens, (jr.license, len(jr.prompt))
        assert len(tr.out_tokens) == tr.max_new_tokens


def test_same_schedule_and_preemptions(streams):
    jgw, _, tgw, _ = streams
    assert list(tgw.trace) == list(jgw.trace)
    assert tgw.stats["preempted"] == jgw.stats["preempted"] > 0
    for key in ("completed", "tokens_generated", "decode_steps",
                "prefill_chunks", "max_blocks_in_use"):
        assert tgw.stats[key] == jgw.stats[key], key
    assert tgw.pool.allocator.num_held == 0
    assert not tgw.decode_kernels            # CPU: the plain decode path


def test_sampling_is_seeded_and_top1_is_greedy(weights):
    """Sampled lanes draw from per-(seed, token) generators: a rerun
    reproduces them, and top_k=1 leaves only the argmax to draw."""
    _, _, cfg, params = weights

    def run(**kw):
        gw = LicensedGateway(cfg, params,
                             tiers={"free": LicenseTier(name="free", masks=FREE)},
                             device="cpu", **GEOMETRY)
        reqs = [gw.submit(_prompt(i, n), license=tier, max_new_tokens=6 + i % 3,
                          seed=i, **kw) for i, (tier, n) in enumerate(STREAM)]
        gw.run()
        return [r.out_tokens for r in reqs]

    hot = run(temperature=1.5)
    assert hot == run(temperature=1.5)
    assert all(0 <= t < cfg.vocab_size for toks in hot for t in toks)
    assert run(temperature=1.0, top_k=1) == run(temperature=0.0)


def _allocator_trace(alloc):
    """Drive an allocator through grants, shared references and every
    guard; record each result or the exception type."""
    def attempt(fn, *a):
        try:
            return fn(*a)
        except ValueError as e:
            return type(e).__name__
    got = attempt(alloc.alloc, 3)
    b0 = got[0]
    return [got, alloc.can_alloc(1), alloc.can_alloc(2), attempt(alloc.alloc, 2),
            attempt(alloc.incref, b0),
            attempt(alloc.free, [b0]),            # shared: refused
            attempt(alloc.decref, b0), attempt(alloc.decref, b0),
            attempt(alloc.decref, b0),            # over-release
            attempt(alloc.incref, b0),            # incref on a freed block
            attempt(alloc.free, [got[1]]), attempt(alloc.free, [got[1]]),
            attempt(alloc.alloc, -1), alloc.stats()]


def test_block_allocator_guards_match_jax():
    assert _allocator_trace(BlockAllocator(4)) == _allocator_trace(JaxBlockAllocator(4))


def test_left_out_arguments_raise(weights):
    _, _, cfg, params = weights
    for kw, item in ((dict(quantized=True), "in-scan int8 dequant"),
                     (dict(lease_ttl_s=5.0), "lease")):
        with pytest.raises(NotImplementedError, match=item):
            LicensedGateway(cfg, params, device="cpu", **kw)
    with pytest.raises(ValueError, match="CUDA"):
        LicensedGateway(cfg, params, device="cpu", decode_kernels=True)
    # as in the JAX slot: a watermark leaving no room for one prefill
    # (max_prompt 32 over 16-token blocks: 2 of the 48 default blocks)
    with pytest.raises(ValueError, match="watermark_blocks=47 leaves no room"):
        LicensedGateway(cfg, params, device="cpu", watermark_blocks=47)
    LicensedGateway(cfg, params, device="cpu", watermark_blocks=46)
    with pytest.raises(TypeError):
        LicensedGateway(cfg, params, device="cpu", no_such_option=1)
    with pytest.raises(ValueError, match="params live on cpu"):
        LicensedGateway(cfg, params, device="meta")


def _reference_defaults():
    """Every keyword argument of the JAX slot with its default."""
    sig = inspect.signature(JaxModelSlot.__init__)
    return {n: p.default for n, p in sig.parameters.items()
            if p.default is not inspect.Parameter.empty}


def test_slot_takes_every_reference_default(weights):
    """A slot built with every keyword default of the JAX slot, except
    those whose features are queued (the lease: its JAX defaults turn it
    on).  Each of those raises ``NotImplementedError`` naming its
    ROADMAP.md item on its own.  ``telemetry=True`` and ``sanitize=None``
    are ported: the slot records, and sanitizes only on request."""
    _, _, cfg, params = weights
    queued = {"lease_ttl_s", "lease_grace_s", "lease_policy"}
    defaults = _reference_defaults()
    assert queued < set(defaults)
    kw = {n: v for n, v in defaults.items() if n not in queued}
    gw = LicensedGateway(cfg, params, device="cpu", **kw)
    assert gw.chunk_size == gw.pool.block_size and not gw.quantized
    assert gw.prefix is not None             # the JAX default: cache on
    assert gw.completed.maxlen == gw.trace.maxlen == defaults["history"]
    assert defaults["telemetry"] is True and defaults["sanitize"] is None
    assert gw.obs and gw.tracer.enabled and gw.audit.enabled
    assert (gw.sanitizer is not None) == (os.environ.get("REPRO_SANITIZE", "")
                                          not in ("", "0"))
    for name in sorted(queued):
        with pytest.raises(NotImplementedError, match=re.escape(_LEFT_OUT[name][1])):
            LicensedGateway(cfg, params, device="cpu", **{name: defaults[name]})


# one value each that the JAX slot takes and the port does not implement
_UNPORTED = {"chunk_size": 0, "decode_pallas": "off",
             "fuse_sampling": False, "record_logits": True}


@pytest.mark.parametrize("name", sorted(_UNPORTED))
def test_unported_value_names_its_roadmap_item(weights, name):
    _, _, cfg, params = weights
    item = _LEFT_OUT[name][1]
    assert item.split(" (")[0] in ROADMAP.read_text().lower()
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        LicensedGateway(cfg, params, device="cpu", **{name: _UNPORTED[name]})


@pytest.mark.parametrize("flags", [[], ["--int8-views"]])
def test_serve_entry_point_on_cpu(flags, capsys):
    """``python -m repro_torch.launch.serve`` at smoke size on the CPU
    (the card is its default device)."""
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen2.5-3b", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--new-tokens", "3", *flags])
    out = capsys.readouterr().out
    assert "tier=full:" in out and "tier=free:" in out
    assert "served 4 requests, 12 tokens on cpu" in out


def test_import_loads_neither_jax_nor_repro():
    """Every module of the port imports without jax, the JAX package or
    ml_dtypes: the port needs none of them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'repro', 'ml_dtypes'))\n"
        "assert len(names) > 20, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
