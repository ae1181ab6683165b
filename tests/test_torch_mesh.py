"""The port under a mesh, on the CPU: the sharded steps on a gloo world
of 4 ranks, and the mesh dry run on torch's fake world.

(a) ``_mesh_worker.run`` on 4 spawned ranks over a ``FileStore``, one
torch thread each, one world per arch (``_gloo_world``: one world at a
time across pytest's workers, each rank's exit code and log tail in the
error of a world that fails): the smoke variants of qwen2.5-3b, deepseek-moe-16b
and mamba2-130m in f32, with the JAX package's ``init_params(PRNGKey(0))``
weights, every leaf placed by ``distribution.sharding`` on a (2, 2)
mesh, run ``prefill_step`` and 4 greedy ``serve_step``s.  They must give the unsharded port's greedy tokens and
logits within 2e-5 x max(|logit|, 1) (the sharded products sum in
another order), and qwen2.5-3b's the JAX package's ``serve_step``
within ``tests/test_torch_model.py``'s 1e-4.  qwen2.5-3b's int8 store
runs on a (1, 4) mesh, where its 2 kv heads do not divide over the query
heads' 4 shards: the in-scan int8 dequant of every unit, gathered, must
equal the unsharded ``dequant_tree`` bit for bit, and its steps the
unsharded in-scan steps.

qwen2.5-3b's steps at 2 rows on a (4, 1) mesh, a batch the data axis
does not divide, must give the unsharded steps' tokens and logits too.

qwen2.5-3b's float steps on (2, 2), where ``layers.write_at`` writes
the cache shard by shard, and its in-scan steps on (1, 4) run again
through ``serving.compiled.MeshGraphs`` on ``_mesh_worker``'s recording
backend, every warm-up, capture and replay under its host-sync guard:
the eager sharded steps' tokens, their logits bit for bit, and the JAX
``serve_step``'s within 1e-4.

(b) ``launch.dryrun.dry_run`` with a mesh on the fake world (made in a
fixture, destroyed at teardown): decode, prefill and train at (2, 2)
and (16, 16) on smoke variants, a rank's bytes equal to its local
shards', and at 4 rows on (16, 16), a batch the data axis does not
divide; no collective bytes on (1, 1), and ``launch.analyze``'s three
tables.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.models import init_params as jax_init_params
from repro.serving.engine import prefill_step as jax_prefill_step
from repro.serving.engine import serve_step as jax_serve_step

import _mesh_worker as W
from _gloo_world import run_world, shared_dir
from repro_torch.core.licensing import LicenseTier
from repro_torch.core.pytree_io import flatten_params
from repro_torch.distribution import sharding as shd
from repro_torch.launch import analyze, dryrun, mesh as mesh_lib, shapes
from repro_torch.models import model as model_lib
from repro_torch.serving.engine import prefill_step, serve_step
from repro_torch.serving.quantized import dequant_tree, quantize_serving_params, tier_intervals
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
# a world's deadline, counted from when it holds the lock: the slowest of
# the three per-arch worlds (qwen2.5-3b's, with its int8, graph and uneven
# steps) ran at most 60.1 s, with the whole suite on six xdist workers
# (``-n 6 --dist loadfile``) or under the README's stress command; 300 s
# is 5 times that, and the slowest world of either file took 105.6 s
SPAWN_TIMEOUT_S = 300


def _jax_cfg(arch):
    jcfg = jax_smoke_variant(jax_get_config(arch))
    return jcfg.replace(vocab_size=500) if arch == "qwen2.5-3b" else jcfg


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``world(arch)``: write the arch's JAX weights, run its 4-rank world
    (one world per arch, one world at a time across pytest's workers),
    return its ``out.npz`` and {arch: the port's params on the CPU}."""
    cache = {}

    def get(arch):
        if arch not in cache:
            d = tmp_path_factory.mktemp(f"mesh_{arch}")
            flat = {k: np.asarray(v) for k, v in jax_flatten_params(
                jax_init_params(jax.random.PRNGKey(0), _jax_cfg(arch))).items()}
            np.savez(d / f"{arch}.npz", **flat)
            run_world(W.run, 4, d, SPAWN_TIMEOUT_S, shared_dir(tmp_path_factory),
                      args=((arch,),), name=f"mesh/{arch}")
            cache[arch] = (dict(np.load(d / "out.npz")),
                           {arch: model_lib.params_from_jax(flat, device="cpu")})
        return cache[arch]

    return get


def plain_steps(cfg, params, toks, license_intervals=None):
    """The unsharded port on the same schedule as ``W.sharded_steps``,
    the tokens its own greedy picks."""
    b = toks.shape[0]
    cache = model_lib.init_cache(cfg, b, W.CAP, device="cpu")
    lg, cache = prefill_step(params, cfg, torch.from_numpy(toks), cache,
                             license_intervals=license_intervals)
    logits, out = [lg.numpy()], []
    for i in range(W.STEPS):
        nxt = torch.from_numpy(logits[-1].argmax(-1)[:, None])
        out.append(nxt[:, 0].numpy())
        pos = torch.full((b,), W.S + i, dtype=torch.int32)
        lg, cache = serve_step(params, cfg, nxt, cache, pos, license_intervals)
        logits.append(lg.numpy())
    return np.stack(logits), np.stack(out)


def _close(got, want):
    tol = 2e-5 * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_steps_match_unsharded(world, arch):
    out, params = world(arch)
    want_logits, want_tokens = plain_steps(W.config(arch), params[arch], W.tokens(arch))
    np.testing.assert_array_equal(out[f"{arch}/tokens"], want_tokens)
    _close(out[f"{arch}/logits"], want_logits)
    if arch == "qwen2.5-3b":               # the padded ids stay masked
        assert (out[f"{arch}/logits"][..., 500:] == -1e9).all()


def test_uneven_batch_steps_match_unsharded(world):
    """2 rows on 4 data ranks: the products' rows DTensor cannot split
    evenly are made whole (``layers.matmul``), and the steps give the
    unsharded port's tokens and logits."""
    out, params = world("qwen2.5-3b")
    want_logits, want_tokens = plain_steps(W.config("qwen2.5-3b"), params["qwen2.5-3b"],
                                           W.tokens("qwen2.5-3b", W.UNEVEN))
    np.testing.assert_array_equal(out["uneven/tokens"], want_tokens)
    _close(out["uneven/logits"], want_logits)


def test_sharded_qwen_matches_jax(world):
    out, _ = world("qwen2.5-3b")
    jcfg = _jax_cfg("qwen2.5-3b")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    from repro.models import model as jax_model

    cache = jax_model.init_cache(jcfg, W.B, W.CAP)
    lg, cache = jax_prefill_step(jparams, jcfg, W.tokens("qwen2.5-3b").astype(np.int32), cache)
    want = [np.asarray(lg)]
    for i in range(W.STEPS):
        nxt = out["qwen2.5-3b/tokens"][i][:, None].astype(np.int32)
        lg, cache = jax_serve_step(jparams, jcfg, nxt, cache, W.S + i)
        want.append(np.asarray(lg))
    np.testing.assert_allclose(out["qwen2.5-3b/logits"], np.stack(want), atol=1e-4, rtol=1e-4)


def _jax_steps(tokens):
    """qwen2.5-3b's JAX prefill and ``serve_step``s fed ``tokens``
    (steps, B): logits (steps + 1, B, V)."""
    from repro.models import model as jax_model

    jcfg = _jax_cfg("qwen2.5-3b")
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cache = jax_model.init_cache(jcfg, W.B, W.CAP)
    lg, cache = jax_prefill_step(jparams, jcfg, W.tokens("qwen2.5-3b").astype(np.int32), cache)
    want = [np.asarray(lg)]
    for i in range(W.STEPS):
        lg, cache = jax_serve_step(jparams, jcfg, tokens[i][:, None].astype(np.int32), cache,
                                   W.S + i)
        want.append(np.asarray(lg))
    return np.stack(want)


@pytest.mark.parametrize("run,eager", [("graph", "qwen2.5-3b"), ("int8_graph", "int8")])
def test_mesh_graphs_match_eager_sharded_steps(world, run, eager):
    """The prefill's capture ran the step (no replay), each decode key
    captured once and replayed every step, and the tokens and the logits
    are the eager sharded steps', bit for bit."""
    out, _ = world("qwen2.5-3b")
    np.testing.assert_array_equal(out[f"{run}/tokens"], out[f"{eager}/tokens"])
    np.testing.assert_array_equal(out[f"{run}/logits"], out[f"{eager}/logits"])
    assert out[f"{run}/counts"].tolist() == [2, W.STEPS]


def test_mesh_graphs_match_jax(world):
    out, _ = world("qwen2.5-3b")
    np.testing.assert_allclose(out["graph/logits"], _jax_steps(out["graph/tokens"]),
                               atol=1e-4, rtol=1e-4)


def test_sharded_in_scan_dequant_is_bit_identical(world):
    out, params = world("qwen2.5-3b")
    cfg = W.config("qwen2.5-3b")
    store = quantize_serving_params(params["qwen2.5-3b"])
    li = tier_intervals(LicenseTier(name="free", masks={"*": ((0.0, 0.01),)}), device="cpu")
    n = 0
    for u in range(cfg.pattern_units):
        view = dequant_tree(model_lib._unit(store["units"], u), li, cfg.dtype)
        for name, leaf in flatten_params(view).items():
            np.testing.assert_array_equal(out[f"int8/units/{u}/{name}"], leaf.numpy(),
                                          err_msg=name)
            n += 1
    assert n == cfg.pattern_units * len(flatten_params(view))
    want_logits, want_tokens = plain_steps(cfg, store, W.tokens("qwen2.5-3b"), li)
    np.testing.assert_array_equal(out["int8/tokens"], want_tokens)
    _close(out["int8/logits"], want_logits)
    assert (out["int8/logits"][..., 500:] == -1e9).all()


def test_dequant_refuses_a_dtensor_outside_local_map():
    from repro_torch.kernels.masked_dequant import masked_dequant

    m = mesh_lib.make_host_mesh(device="cpu")
    try:
        codes = shd.distribute_tree({"c": torch.ones(4, 8, dtype=torch.int8)},
                                    {"c": shd.replicated(m)}, m)["c"]
        lo = hi = torch.zeros(8)
        with pytest.raises(TypeError, match="local_map"):
            masked_dequant(codes, torch.ones(1, 8), lo, hi)
        assert (m.mesh_dim_names, tuple(m.shape)) == (("data", "model"), (1, 1))
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------------------------ the mesh dry run
@pytest.fixture
def fake_mesh(request):
    """A fake world and a (data, model) mesh of ``request.param``'s shape."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = request.param
    mesh_lib.fake_world(int(np.prod(shape)))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    finally:
        torch.distributed.destroy_process_group()


DRY_ARCHS = ("qwen2.5-3b", "deepseek-moe-16b", "mamba2-130m")


@pytest.mark.parametrize("fake_mesh", [(2, 2), (16, 16)], indirect=True,
                         ids=["2x2", "16x16"])
@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_mesh_dry_run(fake_mesh, arch):
    from repro_torch.configs import get_config, smoke_variant

    cfg = smoke_variant(get_config(arch))
    chips = fake_mesh.size()
    batch = fake_mesh.shape[0]              # one row a data rank
    for kind in ("decode", "prefill", "train"):
        shape = shapes.InputShape(f"s_{kind}", kind, 16, batch)
        plain = dryrun.dry_run(cfg, shape)
        rep = dryrun.dry_run(cfg, shape, mesh=fake_mesh)
        assert rep["chips"] == chips and rep["mesh"] == "x".join(map(str, fake_mesh.shape))
        assert rep["flops"] == plain["flops"]          # the global count, unchanged
        assert rep["compute_s"] == pytest.approx(plain["compute_s"] / chips)
        # a rank's bytes are its local shards', never more than the whole
        _, spec = shapes.input_specs(cfg, shape)
        params = model_lib.init_params(cfg, device="meta")
        placed = shd.distribute_tree(params, shd.params_shardings(params, fake_mesh, cfg),
                                     fake_mesh)
        assert rep["weight_bytes"] == sum(
            t.to_local().numel() * t.element_size() for t in flatten_params(placed).values())
        assert 0 < rep["weight_bytes"] <= plain["weight_bytes"]
        if kind != "train":
            cache = shd.distribute_tree(
                spec["cache"], shd.cache_shardings(spec["cache"], fake_mesh, batch), fake_mesh)
            assert rep["cache_bytes"] == shd.local_bytes(cache) <= plain["cache_bytes"]
        assert rep["collective_bytes"] > 0 and rep["collective_count"] > 0
        assert rep["collective_bytes"] == sum(
            v for k, v in rep["collectives"].items() if k.endswith("_bytes"))
        assert rep["bound_s"] == max(rep["compute_s"], rep["memory_s"], rep["collective_s"])


@pytest.mark.parametrize("fake_mesh", [(16, 16)], indirect=True, ids=["16x16"])
@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_mesh_dry_run_uneven_batch(fake_mesh, arch):
    """4 rows on 16 data ranks: DTensor would shard a product's 128
    flattened rows over the data axis and then fail to unflatten them;
    ``layers.matmul`` makes such rows whole, and the report counts the
    unsharded run's flops."""
    from repro_torch.configs import get_config, smoke_variant

    cfg = smoke_variant(get_config(arch))
    for kind in ("prefill", "decode", "train"):
        shape = shapes.InputShape(f"s_{kind}", kind, 32, 4)
        plain = dryrun.dry_run(cfg, shape)
        rep = dryrun.dry_run(cfg, shape, mesh=fake_mesh)
        assert rep["flops"] == plain["flops"], kind
        assert rep["compute_s"] == pytest.approx(plain["compute_s"] / 256)
        assert 0 < rep["weight_bytes"] <= plain["weight_bytes"]
        assert rep["collective_bytes"] > 0 and rep["collective_count"] > 0


@pytest.mark.parametrize("fake_mesh", [(1, 1)], indirect=True, ids=["1x1"])
def test_one_rank_moves_no_collective_bytes(fake_mesh):
    from repro_torch.configs import get_config, smoke_variant

    cfg = smoke_variant(get_config("qwen2.5-3b"))
    for kind in ("decode", "train"):
        shape = shapes.InputShape(f"s_{kind}", kind, 16, 4)
        rep = dryrun.dry_run(cfg, shape, mesh=fake_mesh)
        plain = dryrun.dry_run(cfg, shape)
        assert rep["collective_bytes"] == 0 and rep["collective_s"] == 0
        for k in ("weight_bytes", "cache_bytes", "resident_bytes", "flops"):
            assert rep[k] == plain[k], k


def test_report_without_mesh_keeps_its_fields():
    from repro_torch.configs import get_config, smoke_variant

    rep = dryrun.dry_run(smoke_variant(get_config("qwen2.5-3b")),
                         shapes.InputShape("d", "decode", 32, 2))
    assert not {"chips", "collective_bytes", "collective_s", "mesh"} & set(rep)


@pytest.mark.parametrize("fake_mesh", [(2, 2)], indirect=True, ids=["2x2"])
def test_analyze_prints_three_tables(fake_mesh, capsys):
    from repro_torch.configs import get_config, smoke_variant

    cfg = smoke_variant(get_config("deepseek-moe-16b"))
    shape = shapes.InputShape("s_prefill", "prefill", 32, 4)
    cost = analyze.op_cost.OpCostMode()
    rep = dryrun.dry_run(cfg, shape, mesh=fake_mesh, cost=cost)
    assert cost.collectives.total_bytes == rep["collective_bytes"] > 0
    assert sum(cost.collective_by_site.values()) == rep["collective_bytes"]
    assert sum(cost.flops_by_site.values()) == cost.flops == rep["device_flops"]
    assert cost.flops < rep["flops"]                   # a rank's share of the global count
    assert any(k.startswith("models/moe.py:") for k in cost.flops_by_site)
    analyze.print_tables(rep, cost, top=5)
    text = capsys.readouterr().out
    for title in ("-- top traffic", "-- top flops", "-- top collectives"):
        assert title in text


def test_mesh_modules_import_no_jax():
    code = ("import sys; import repro_torch.distribution, repro_torch.launch.mesh, "
            "repro_torch.launch.op_cost, repro_torch.launch.analyze, "
            "repro_torch.launch.dryrun, repro_torch.launch.roofline; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro']; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_production_mesh_needs_its_world():
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_production_mesh()
    mesh_lib.fake_world(4)
    try:
        with pytest.raises(ValueError, match="256 ranks"):
            mesh_lib.make_production_mesh()
    finally:
        torch.distributed.destroy_process_group()


def test_dryrun_cli_with_mesh(tmp_path, capsys, monkeypatch):
    """``--mesh single`` runs on the 256-rank fake world and names the
    mesh in each report and file; the world is gone afterwards."""
    from repro_torch.configs import smoke_variant

    real = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda a: smoke_variant(real(a)))
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k", "--mesh", "single",
                        "--out", str(tmp_path)]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["mesh"] == "16x16" and rep["chips"] == 256
    assert (tmp_path / "qwen2.5-3b__decode_32k__256.json").exists()
    assert not torch.distributed.is_initialized()
