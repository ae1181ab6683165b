"""The port's runtime sanitizer against the JAX package's, on the CPU.

The cases of ``tests/test_sanitize.py`` run through both packages: each
package's ``ServingSanitizer`` attached to its own ``BlockAllocator``
must raise ``SanitizerError`` with the same message on the same seeded
violation (double free, use-after-free, free of a shared block,
free-list corruption, shadow divergence, a decode write to a freed or a
shared block, a leak at drain, the step-shape bound), and accept the
same clean lifecycles.  Then the port's gateway with ``sanitize=True``
serves a shared-prefix stream (hits, copy-on-write, eviction and
preemption) clean, with the same sentinel counts as the sanitized JAX
gateway on the same stream, and an injected double free or leak is
caught at the operation.
"""
import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.analysis import sanitize as jax_sanitize
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.models import init_params as jax_init_params
from repro.serving import LicensedGateway as JaxGateway
from repro.serving.paging import BlockAllocator as JaxBlockAllocator

from repro_torch.analysis import sanitize as torch_sanitize
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models.model import params_from_jax
from repro_torch.serving import LicensedGateway, RequestState
from repro_torch.serving.paging import BlockAllocator
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

PACKAGES = {"jax": (jax_sanitize, JaxBlockAllocator),
            "torch": (torch_sanitize, BlockAllocator)}


def _attached(pkg, num_blocks=8):
    san_mod, alloc_cls = PACKAGES[pkg]
    alloc = alloc_cls(num_blocks)
    san = san_mod.ServingSanitizer()
    san.attach_allocator(alloc)
    return alloc, san


def _raises(pkg, pattern, fn, *args):
    """Run ``fn(*args)``; it must raise the package's SanitizerError
    matching ``pattern``.  Returns the message."""
    with pytest.raises(PACKAGES[pkg][0].SanitizerError, match=pattern) as info:
        fn(*args)
    return str(info.value)


# ------------------------------------------------------------ shadow mirror
def _clean_lifecycle(pkg):
    alloc, san = _attached(pkg)
    a, b = alloc.alloc(2)
    log = [dict(san.shadow), alloc.incref(a), alloc.decref(a), alloc.decref(b)]
    alloc.free([a])
    return log + [dict(san.shadow), alloc.num_held]


def _double_free(pkg):
    alloc, _ = _attached(pkg)
    (b,) = alloc.alloc(1)
    alloc.free([b])
    return [_raises(pkg, "double free", alloc.free, [b]),
            _raises(pkg, "double free", alloc.decref, b)]


def _use_after_free(pkg):
    alloc, _ = _attached(pkg)
    (b,) = alloc.alloc(1)
    alloc.decref(b)
    return [_raises(pkg, "use-after-free", alloc.incref, b)]


def _free_of_shared_block(pkg):
    alloc, _ = _attached(pkg)
    (b,) = alloc.alloc(1)
    alloc.incref(b)
    return [_raises(pkg, "shared", alloc.free, [b])]


def _free_list_corruption(pkg):
    alloc, _ = _attached(pkg, num_blocks=2)
    got = alloc.alloc(2)
    alloc._free.append(got[0])           # seeded corruption: live id re-listed
    return [_raises(pkg, "free-list corruption", alloc.alloc, 1)]


def _shadow_divergence(pkg):
    alloc, _ = _attached(pkg)
    a, b = alloc.alloc(2)
    alloc._ref[a] += 1                   # mutation behind the wrappers' back
    return [_raises(pkg, "divergence", alloc.decref, b)]


def _attach_requirements(pkg):
    san_mod, alloc_cls = PACKAGES[pkg]
    alloc = alloc_cls(4)
    alloc.alloc(1)
    msgs = [_raises(pkg, "live blocks", san_mod.ServingSanitizer().attach_allocator, alloc)]
    _, san = _attached(pkg)
    return msgs + [_raises(pkg, "already attached", san.attach_allocator, alloc_cls(4))]


def _req(rid, blocks, pos):
    return SimpleNamespace(rid=rid, blocks=blocks, pos=pos)


def _decode_write_to_freed_block(pkg):
    alloc, san = _attached(pkg)
    a, b = alloc.alloc(2)
    alloc.decref(b)                      # freed, but the table still holds it
    pool = SimpleNamespace(block_size=4)
    return [_raises(pkg, "freed block", san.check_decode_writes,
                    [_req("r0", [a, b], pos=5)], pool)]


def _decode_write_to_shared_block(pkg):
    alloc, san = _attached(pkg)
    a, b = alloc.alloc(2)
    alloc.incref(b)                      # tail shared (e.g. by the prefix tree)
    pool = SimpleNamespace(block_size=4)
    msg = _raises(pkg, "without CoW", san.check_decode_writes,
                  [_req("r0", [a, b], pos=5)], pool)
    alloc.decref(b)                      # exclusively owned again: passes
    san.check_decode_writes([_req("r0", [a, b], pos=5)], pool)
    return [msg]


def _leak_at_drain(pkg):
    alloc, san = _attached(pkg)
    a, b, c = alloc.alloc(3)
    req = _req("r0", [a], pos=0)
    gw = SimpleNamespace(scheduler=SimpleNamespace(running=[req], waiting=[]),
                         prefix=SimpleNamespace(_by_block={b: object()}))
    san.after_step(gw)                   # every request block live: fine
    msgs = [_raises(pkg, rf"leak at drain.*{c}", san.check_drained, gw)]
    alloc.decref(c)
    san.check_drained(gw)                # prefix-retained b is not a leak
    alloc.decref(b)
    req.blocks = [a, b]                  # a table entry outlived its block
    return msgs + [_raises(pkg, "holds freed block", san.after_step, gw)]


def _retrace_bound(pkg):
    rt = PACKAGES[pkg][0].RetraceSentinel()
    rt.bound("decode_width", 2)
    for key in (4, 4, 8):                # a repeated key is no new shape
        rt.note("decode_width", key)
    log = [rt.stats()]
    msg = _raises(pkg, "decode_width.*over its bound", rt.note, "decode_width", 16)
    rt.note("unbounded_family", "x")     # families without bounds only count
    # the messages differ in one word: the port has step shapes, not jits
    return log + [re.sub(r"\b(jit|step) family", "family", msg), rt.stats()]


CASES = {f.__name__.strip("_"): f for f in (
    _clean_lifecycle, _double_free, _use_after_free, _free_of_shared_block,
    _free_list_corruption, _shadow_divergence, _attach_requirements,
    _decode_write_to_freed_block, _decode_write_to_shared_block, _leak_at_drain,
    _retrace_bound)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sanitizer_case_matches_jax(name):
    assert CASES[name]("torch") == CASES[name]("jax")


@pytest.mark.parametrize("value,armed", [(None, False), ("0", False), ("", False),
                                         ("1", True), ("yes", True)])
def test_env_opt_in_matches_jax(monkeypatch, value, armed):
    if value is None:
        monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    else:
        monkeypatch.setenv("REPRO_SANITIZE", value)
    assert torch_sanitize.sanitize_from_env() is jax_sanitize.sanitize_from_env() is armed


# ------------------------------------------------------------- end to end
FREE = {"*": ((0.0, 0.01),)}
GEOMETRY = dict(max_batch=2, max_lanes=4, max_prompt=8, max_new_cap=8,
                block_size=4, num_blocks=7)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    params = params_from_jax(jax_flatten_params(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _shared_stream():
    rng = np.random.default_rng(0)
    head = rng.integers(0, 500, 4, dtype=np.int32)
    out = [np.concatenate([head, rng.integers(0, 500, 4 - i % 3, dtype=np.int32)])
           for i in range(5)]
    return out + [out[1], out[0]]


def _serve(gw):
    reqs = [gw.submit(p, max_new_tokens=5 + 2 * (i % 2))
            for i, p in enumerate(_shared_stream())]
    gw.run()
    return reqs


@pytest.fixture(scope="module")
def sanitized(weights):
    jcfg, jparams, cfg, params = weights
    jgw = JaxGateway(jcfg, jparams, sanitize=True, telemetry=False, **GEOMETRY)
    tgw = LicensedGateway(cfg, params, sanitize=True, device="cpu", **GEOMETRY)
    return jgw, _serve(jgw), tgw, _serve(tgw)


def test_sanitized_gateway_serves_shared_prefix_stream_clean(sanitized):
    jgw, jreqs, tgw, treqs = sanitized
    assert all(r.state == RequestState.DONE for r in treqs), [r.error for r in treqs]
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert tgw.stats["preempted"] > 0 and tgw.stats["cow_copies"] > 0
    assert tgw.stats["prefix_tokens_reused"] > 0
    assert tgw.prefix.stats()["evicted_blocks"] == jgw.prefix.stats()["evicted_blocks"]
    # the shadow tracked every mutation and agrees with the allocator; at
    # the drain only the prefix tree holds blocks
    assert tgw.sanitizer.shadow == dict(tgw.pool.allocator._ref)
    assert set(tgw.sanitizer.shadow) == set(tgw.prefix._by_block)


def test_sanitized_gateway_step_shapes_match_jax(sanitized):
    jgw, _, tgw, _ = sanitized
    got = tgw.sanitizer.retrace.stats()
    assert got == jgw.sanitizer.retrace.stats()
    assert set(got) == {"prefill_chunk", "prefix_prefill", "decode_width", "paged_decode"}
    # every family the JAX slot bounds, the bucket prefill's and the
    # gather/scatter decode's ("steps") included
    assert tgw.sanitizer.retrace._bounds == jgw.sanitizer.retrace._bounds


def test_env_opt_in_arms_the_gateway(weights, monkeypatch):
    _, _, cfg, params = weights
    kw = dict(max_batch=1, max_prompt=4, max_new_cap=4, block_size=4, device="cpu")
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert LicensedGateway(cfg, params, **kw).sanitizer is not None
    assert LicensedGateway(cfg, params, sanitize=False, **kw).sanitizer is None
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert LicensedGateway(cfg, params, **kw).sanitizer is None


def test_sanitized_gateway_catches_injected_double_free(weights):
    _, _, cfg, params = weights
    gw = LicensedGateway(cfg, params, sanitize=True, max_batch=1, max_prompt=8,
                         max_new_cap=4, block_size=4, prefix_cache=False, device="cpu")
    alloc = gw.pool.allocator
    got = alloc.alloc(1)
    alloc.decref(got[0])
    with pytest.raises(torch_sanitize.SanitizerError, match="double free"):
        alloc.decref(got[0])


def test_sanitized_gateway_catches_leak_at_drain(weights):
    """A block allocated behind the gateway's back and never released is
    unreachable once the queue drains: ``run`` raises."""
    _, _, cfg, params = weights
    gw = LicensedGateway(cfg, params, sanitize=True, max_batch=1, max_prompt=8,
                         max_new_cap=4, block_size=4, num_blocks=6, device="cpu")
    gw.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=2)
    (leaked,) = gw.pool.allocator.alloc(1)
    with pytest.raises(torch_sanitize.SanitizerError, match=rf"leak at drain.*{leaked}"):
        gw.run()


def test_sanitized_gateway_catches_write_to_shared_block(weights):
    """A decode whose copy-on-write is skipped would write the prompt's
    tail block, which the prefix tree shares from the first token on:
    ``check_decode_writes`` stops the step."""
    _, _, cfg, params = weights
    gw = LicensedGateway(cfg, params, sanitize=True, device="cpu", **GEOMETRY)
    gw._grow_block_tables = lambda reqs: list(reqs)      # no growth, no CoW
    req = gw.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=4)
    with pytest.raises(torch_sanitize.SanitizerError, match="without CoW"):
        gw.run()
    assert len(req.out_tokens) == 1                      # the prefill's token only
