"""The port's compression pipeline (paper Fig. 3) and the quickstart's
publish -> calibrate -> pull -> delta-sync steps against the JAX package,
on the CPU.

Weights: the reference's ``init_params(PRNGKey(0), smoke_variant(
qwen2.5-3b))`` in f32 and cast to bf16 (``ml_dtypes`` arrays carried
across bit for bit), and the paper's two Table 1 MLPs
(``init_mlp_params``' distribution, drawn with numpy).  Prune masks, int8 codes, scales, dequantized
values, ``nbytes`` and ``CompressionStats`` must be IDENTICAL; k-means
codebooks agree at rtol 1e-5 and indices wherever the value's two nearest
centroids lie more than 1e-4 apart (``segment_sum`` and ``index_add_``
sum in different orders).  The quickstart runs from one JAX-made pruned
MLP through each package's ``WeightStore`` / ``LicenseServer`` /
``EdgeClient``: the same tier, trace and accuracies, client params bit
for bit, the same packets.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.configs.paper_mlp import TABLE1_A as JAX_TABLE1_A
from repro.configs.paper_mlp import TABLE1_B as JAX_TABLE1_B
from repro.core import compression as jc
from repro.core.licensing import calibrate_license as jax_calibrate_license
from repro.core.protocol import EdgeClient as JaxEdgeClient
from repro.core.protocol import LicenseServer as JaxLicenseServer
from repro.core.pytree_io import flatten_params as jax_flatten_params
from repro.core.weightstore import WeightStore as JaxWeightStore
from repro.data import classification_data as jax_classification_data
from repro.models import init_params as jax_init_params
from repro.training import mlp_accuracy as jax_mlp_accuracy

from repro_torch.configs.paper_mlp import TABLE1_A, TABLE1_B
from repro_torch.core import compression as tc
from repro_torch.core.licensing import calibrate_license
from repro_torch.core.protocol import EdgeClient, LicenseServer
from repro_torch.core.pytree_io import flatten_params
from repro_torch.core.weightstore import WeightStore
from repro_torch.data import classification_data
from repro_torch.models.model import params_from_jax
from repro_torch.training import mlp_accuracy
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _host(t):
    """A port tensor as a host array comparable with the JAX side's."""
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jhost(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@functools.lru_cache(maxsize=None)
def _weights(kind):
    if kind.startswith("smoke"):
        jparams = jax_init_params(jax.random.PRNGKey(0),
                                  jax_smoke_variant(jax_get_config("qwen2.5-3b")))
        if kind == "smoke_bf16":
            jparams = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jparams)
    else:
        # init_mlp_params' distribution, drawn with numpy (jax.random's eager
        # draws would compile per shape)
        mlp = {"a": JAX_TABLE1_A, "b": JAX_TABLE1_B}[kind[-1]]
        dims = (mlp.in_dim, *mlp.hidden, mlp.num_classes)
        rng = np.random.default_rng(3)
        jparams = {f"layer{i + 1}": {
            "kernel": (rng.standard_normal((dims[i], dims[i + 1]))
                       * np.sqrt(2.0 / dims[i])).astype(np.float32),
            "bias_vec": (0.01 * rng.standard_normal(dims[i + 1])).astype(np.float32)}
            for i in range(len(dims) - 1)}
    return jparams, params_from_jax(jax_flatten_params(jparams), device="cpu")


WEIGHTS = ["smoke_f32", "smoke_bf16", "table1_a", "table1_b"]


@pytest.fixture(scope="module", params=WEIGHTS)
def weights(request):
    return _weights(request.param)


def test_mlp_configs_match():
    for ours, ref in ((TABLE1_A, JAX_TABLE1_A), (TABLE1_B, JAX_TABLE1_B)):
        assert ours == type(ours)(**vars(ref))
    assert (TABLE1_A.num_params, TABLE1_B.num_params) == (109_386, 101_770)


@pytest.fixture(scope="module")
def pipelines(weights):
    """``compress_pipeline`` at sparsity 0.8 (the quickstart's) through
    both packages."""
    jparams, params = weights
    timings = {}
    got = tc.compress_pipeline(params, timings=timings)
    assert set(timings) == {"prune", "quantize", "stats"}
    return jc.compress_pipeline(jparams), got


def test_prune_params_identical(weights, pipelines):
    """Masks and kept values bit for bit (``compress_pipeline`` prunes with
    ``prune_params``), and the thresholds themselves (jnp.quantile's f32
    arithmetic)."""
    jparams, params = weights
    (jpruned, _, _), (pruned, _, _) = pipelines
    want, got, flat = (jax_flatten_params(jpruned), flatten_params(pruned),
                       flatten_params(params))
    alone = flatten_params(tc.prune_params(params, 0.8))
    assert list(got) == list(want) == list(alone)
    for name in want:
        assert got[name].dtype == flat[name].dtype
        np.testing.assert_array_equal(_host(got[name]), _jhost(want[name]), err_msg=name)
        assert torch.equal(alone[name], got[name]), name
        if want[name].ndim >= 2:
            thr = tc.magnitude_threshold(flat[name], 0.8)
            assert thr.dtype == torch.float32
            assert float(thr) == float(jc.magnitude_threshold(
                jnp.asarray(jax_flatten_params(jparams)[name]), 0.8)), name


def test_quantize_dequantize_identical(weights, pipelines):
    (_, jquant, _), (_, quant, _) = pipelines
    flat = flatten_params(weights[1])
    assert list(quant) == list(jquant)
    for name, q in quant.items():
        want = jquant[name]
        assert q.codes.dtype == torch.int8 and q.shape == want.shape
        assert q.dtype == flat[name].dtype
        np.testing.assert_array_equal(q.codes.numpy(), np.asarray(want.codes), err_msg=name)
        np.testing.assert_array_equal(q.scale.numpy(), np.asarray(want.scale), err_msg=name)
        assert q.nbytes == want.nbytes
        deq = tc.dequantize(q)
        assert deq.dtype == flat[name].dtype
        np.testing.assert_array_equal(_host(deq), _jhost(jc.dequantize(want)), err_msg=name)


@pytest.mark.parametrize("kw", [{}, dict(sparsity=0.5, codebook_size=None),
                                dict(sparsity=0.9, codebook_size=16, value_bytes_full=4)],
                         ids=["default", "no_codebook", "k16_f32_baseline"])
def test_compress_pipeline_stats_identical(weights, pipelines, kw):
    if not kw:
        (_, _, want), (_, _, got) = pipelines
    else:
        want = jc.compress_pipeline(weights[0], **kw)[2]
        got = tc.compress_pipeline(weights[1], **kw)[2]
    assert vars(got) == vars(want)


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("per_channel", [True, False])
def test_edges_on_the_mlp(sparsity, per_channel):
    """Threshold edge ranks and per-tensor scales, on table1_a's leaves."""
    jparams, params = _weights("table1_a")
    flat = flatten_params(params)
    for name, arr in jax_flatten_params(jparams).items():
        np.testing.assert_array_equal(
            _host(tc.magnitude_prune(flat[name], sparsity)),
            _jhost(jc.magnitude_prune(jnp.asarray(arr), sparsity)), err_msg=name)
        want = jc.quantize_int8(jnp.asarray(arr), per_channel=per_channel)
        got = tc.quantize_int8(flat[name], per_channel=per_channel)
        np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
        assert got.nbytes == want.nbytes


def _nearest_gap(values, codebook):
    d = np.sort(np.abs(values.reshape(-1, 1) - codebook[None, :]), axis=1)
    return d[:, 1] - d[:, 0]


@pytest.mark.parametrize("kind,leaf,k", [
    ("smoke_bf16", "units/b0/ffn/w_up", 32),
    ("table1_a", "layer1/kernel", 32),
    ("table1_b", "layer2/kernel", 8),
])
def test_weight_share_matches(kind, leaf, k):
    jparams, params = _weights(kind)
    arr = jax_flatten_params(jparams)[leaf]
    want = jc.weight_share(jnp.asarray(arr), k=k, iters=25)
    got = tc.weight_share(flatten_params(params)[leaf], k=k, iters=25)
    cb = np.asarray(want.codebook)
    np.testing.assert_allclose(got.codebook.numpy(), cb, rtol=1e-5)
    assert got.indices.dtype == torch.uint8 and got.indices.shape == tuple(arr.shape)
    apart = _nearest_gap(_jhost(arr), cb) > 1e-4
    assert apart.mean() > 0.9
    np.testing.assert_array_equal(got.indices.numpy().reshape(-1)[apart],
                                  np.asarray(want.indices).reshape(-1)[apart])
    assert got.nbytes == want.nbytes
    back = tc.unshare(got)
    assert back.dtype == flatten_params(params)[leaf].dtype
    np.testing.assert_allclose(_host(back), _jhost(jc.unshare(want)), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------ quickstart steps 3-6
@pytest.fixture(scope="module")
def quickstart_mlp():
    """A JAX-made TABLE1_A MLP through the quickstart's steps 1-2 (train
    600 steps, prune 80%, fine-tune 200 steps), and its test split."""
    from repro.training import finetune_pruned_mlp as jax_finetune_pruned_mlp
    from repro.training import train_mlp as jax_train_mlp

    x, y = jax_classification_data(8000, JAX_TABLE1_A.in_dim, JAX_TABLE1_A.num_classes,
                                   seed=0)
    ours = classification_data(8000, TABLE1_A.in_dim, TABLE1_A.num_classes, seed=0)
    assert all(np.array_equal(a, b) for a, b in zip((x, y), ours))
    params = jax_train_mlp(JAX_TABLE1_A, x[:6000], y[:6000], steps=600)
    pruned, _, _ = jc.compress_pipeline(params, sparsity=0.8)
    pruned = jax_finetune_pruned_mlp(JAX_TABLE1_A, pruned, x[:6000], y[:6000], steps=200)
    return jax.device_get(pruned), x[6000:], y[6000:]


def _run_quickstart(pkg, pruned, xte, yte):
    """Steps 3-6 of examples/quickstart.py through one package."""
    if pkg == "jax":
        Store, Server, Client, calibrate = (JaxWeightStore, JaxLicenseServer,
                                            JaxEdgeClient, jax_calibrate_license)
        acc = jax_mlp_accuracy
        flat = {k: np.array(v) for k, v in jax_flatten_params(pruned).items()}

        def nested(f):
            return {layer: {leaf: f[f"{layer}/{leaf}"] for leaf in pruned[layer]}
                    for layer in pruned}

        def host(t):
            return np.asarray(t)
    else:
        Store, Server, Client, calibrate = WeightStore, LicenseServer, EdgeClient, \
            calibrate_license
        acc = mlp_accuracy
        flat = flatten_params(params_from_jax(jax_flatten_params(pruned), device="cpu"))

        def nested(f):
            from repro_torch.core.pytree_io import unflatten
            return unflatten(dict(f))

        def host(t):
            return t.numpy()
    params = nested(flat)
    store = Store(":memory:")
    store.register_model("prod-mlp", "paper-mlp")
    server = Server(store)
    server.publish("prod-mlp", params, tag="v1.0")
    rows = store.storage_bytes("prod-mlp")["weight_rows"]
    tier, trace = calibrate(params, lambda p: acc(p, xte, yte), target_accuracy=0.70,
                            k_intervals=12, tier_name="free")
    server.publish_tier("prod-mlp", tier)
    zeros = {k: (np.zeros_like(v) if pkg == "jax" else torch.zeros_like(v))
             for k, v in flat.items()}
    paid = Client("prod-mlp", dict(zeros), license_name="full")
    free = Client("prod-mlp", dict(zeros), license_name="free")
    p_paid, p_free = paid.request_update(server), free.request_update(server)
    accs = (acc(nested(paid.params), xte, yte), acc(nested(free.params), xte, yte))
    newp = {k: np.array(host(v), copy=True) for k, v in flat.items()}
    newp["layer3/kernel"].reshape(-1)[:25] += 0.01
    server.publish("prod-mlp", nested(newp), tag="v1.1")
    packet = paid.request_update(server)
    out = dict(rows=rows, tier=(tier.name, tier.masks, tier.accuracy),
               trace=[(s.interval, s.layer, s.accuracy) for s in trace], accs=accs,
               pulls=[(p.num_entries, p.nbytes) for p in (p_paid, p_free, packet)],
               bytes=(paid.bytes_downloaded, free.bytes_downloaded),
               clients={k: {n: host(v) for n, v in c.params.items()}
                        for k, c in (("paid", paid), ("free", free))})
    store.close()
    return out


def test_quickstart_steps_match_jax(quickstart_mlp):
    want = _run_quickstart("jax", *quickstart_mlp)
    got = _run_quickstart("torch", *quickstart_mlp)
    assert got["rows"] == want["rows"]
    assert got["tier"] == want["tier"] and got["trace"] == want["trace"]
    assert got["accs"] == want["accs"] and got["accs"][1] < got["accs"][0]
    assert got["pulls"] == want["pulls"] and got["pulls"][2][0] == 25
    assert got["bytes"] == want["bytes"]
    for who in ("paid", "free"):
        assert list(got["clients"][who]) == list(want["clients"][who])
        for name, arr in want["clients"][who].items():
            np.testing.assert_array_equal(got["clients"][who][name], arr, err_msg=name)


def test_port_modules_import_no_jax():
    code = ("import sys; import repro_torch.training, repro_torch.data, "
            "repro_torch.core.compression, repro_torch.configs.paper_mlp, "
            "repro_torch.launch.train; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro']; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
