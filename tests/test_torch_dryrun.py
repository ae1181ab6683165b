"""The port's launch tools (``launch/shapes.py``, ``launch/roofline.py``,
``launch/dryrun.py``) and ``ModelConfig.param_counts`` against the JAX
package's, on the CPU.

``SHAPES``, ``adapt_config``, ``param_counts`` and ``model_step_flops``
must equal the JAX package's exactly for every assigned arch x shape,
and ``input_specs`` must give the shapes and dtypes of JAX's
``eval_shape`` leaf for leaf (the cache layouts are the same trees; the
decode ``pos`` is (B,) in the port, a scalar in JAX, and is not
compared).  MLA under long_500k's sliding window runs on the port's
latent ring: its cache is the window's 4,096 slots, and its counted
flops are the port's own products over them.  The dry run runs one arch of each family (dense, MoE, MLA, SSM, RG-LRU, vision) at
smoke size on the ``meta`` device, every step kind: the counted flops
of the dense, recurrent and vision families must lie within a stated
band of ``model_step_flops``, those of MoE and MLA within 1% of the
port's own products counted by hand.
"""
import json

import jax
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jax_roofline
from repro.launch import shapes as jax_shapes

from repro_torch.configs import ASSIGNED_ARCHS, get_config, smoke_variant
from repro_torch.core.pytree_io import flatten_params
from repro_torch.launch import dryrun, roofline, shapes
from repro_torch.models import moe
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

COMBOS = [(a, s) for a in ASSIGNED_ARCHS for s in shapes.SHAPES]


def test_assigned_archs_and_shapes_match_jax():
    assert ASSIGNED_ARCHS == JAX_ASSIGNED_ARCHS
    assert shapes.SWA_WINDOW == jax_shapes.SWA_WINDOW
    assert {k: vars(v) for k, v in shapes.SHAPES.items()} == \
        {k: vars(v) for k, v in jax_shapes.SHAPES.items()}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_counts_and_model_flops_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_counts() == jcfg.param_counts()
    for name, shape in shapes.SHAPES.items():
        got, note = shapes.adapt_config(cfg, shape)
        want, jnote = jax_shapes.adapt_config(jcfg, jax_shapes.SHAPES[name])
        assert note == jnote
        assert {f: getattr(got, f) for f in ("window", "q_chunk", "num_layers")} == \
            {f: getattr(want, f) for f in ("window", "q_chunk", "num_layers")}
        assert roofline.model_step_flops(got, shape) == \
            jax_roofline.model_step_flops(want, jax_shapes.SHAPES[name])


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_input_specs_match_jax_eval_shape(arch, shape):
    cfg, _ = shapes.adapt_config(get_config(arch), shapes.SHAPES[shape])
    jcfg, _ = jax_shapes.adapt_config(jax_get_config(arch), jax_shapes.SHAPES[shape])
    kind, spec = shapes.input_specs(cfg, shapes.SHAPES[shape])
    jkind, jspec = jax_shapes.input_specs(jcfg, jax_shapes.SHAPES[shape])
    assert kind == jkind
    if kind == "train":
        spec, jspec = spec["batch"], jspec["batch"]
    for name, want in jspec.items():
        if name == "pos":
            assert spec["pos"].shape == (shapes.SHAPES[shape].batch,)
            continue
        if name == "cache":
            got = flatten_params(spec["cache"])
            want = {jax.tree_util.keystr(p, simple=True, separator="/"): leaf
                    for p, leaf in jax.tree_util.tree_leaves_with_path(want)}
            assert set(got) == set(want)
            for k, leaf in want.items():
                assert (tuple(got[k].shape), _dtype(got[k])) == (leaf.shape, _dtype(leaf)), k
            continue
        assert (tuple(spec[name].shape), _dtype(spec[name])) == (want.shape, _dtype(want))
    assert all(t.device.type == "meta" for t in flatten_params(
        {k: v for k, v in spec.items()}).values())


# counted flops over model_step_flops at smoke size: the dense and
# recurrent families within ~3% (the embedding gather is in N but costs no
# flops, attention at 64 tokens adds little)
BANDS = {"qwen2.5-3b": (0.85, 1.15), "mamba2-130m": (0.85, 1.15),
         "recurrentgemma-2b": (0.85, 1.15), "internvl2-26b": (0.85, 1.15)}
# MoE runs every expert over its capacity rows and MLA decompresses the
# whole latent chain, so their counted flops are several times
# model_step_flops (2.2-9.2x at smoke size); they are held instead to
# the port's own products counted by hand (port_flops), within 1%
DISPATCH_TOL = 0.01


def port_flops(cfg, kind, b, s):
    """The matmul flops of the port's MoE / MLA step at (b, s), term by
    term: attention (MLA: the q and latent projections, ``w_ukv`` over
    every key of the cache or sequence, scores, values, output), the
    router, every expert over ``moe.capacity`` rows a batch row, the
    shared experts, and the LM head; backward twice the forward."""
    q = 1 if kind == "decode" else s           # query rows a batch row
    t = s                                      # keys: the cache or the sequence
    tok = b * q
    d, h, e, f = cfg.d_model, cfg.num_heads, cfg.num_experts, cfg.moe_d_ff
    if cfg.use_mla:
        nope, rope, r, vd = cfg.qk_nope_dim, cfg.rope_head_dim, cfg.kv_lora_rank, cfg.v_head_dim
        attn = (2 * tok * d * h * (nope + rope) + 2 * tok * d * (r + rope)
                + 2 * b * t * r * h * (nope + vd)
                + 2 * b * h * q * t * (nope + rope) + 2 * b * h * q * t * vd
                + 2 * tok * h * vd * d)
    else:
        hd, kh = cfg.head_dim, cfg.num_kv_heads
        attn = 4 * tok * d * h * hd + 4 * tok * d * kh * hd + 4 * b * h * q * t * hd
    ffn = (2 * tok * d * e + 6 * b * e * moe.capacity(q, cfg) * d * f
           + 6 * tok * d * f * cfg.num_shared_experts)
    fwd = cfg.num_layers * (attn + ffn) + 2 * tok * d * cfg.vocab_size
    return 3 * fwd if kind == "train" else fwd


@pytest.mark.parametrize("arch", sorted(BANDS) + ["deepseek-moe-16b", "deepseek-v2-lite-16b"])
def test_dryrun_on_meta_counts_flops(arch):
    cfg = smoke_variant(get_config(arch))
    for kind in ("train", "prefill", "decode"):
        for quantized in ((False, True) if kind == "decode" else (False,)):
            shape = shapes.InputShape(f"smoke_{kind}", kind, 64, 2)
            rep = dryrun.dry_run(cfg, shape, quantized=quantized)
            if arch in BANDS:
                lo, hi = BANDS[arch]
                ratio = rep["flops"] / rep["model_flops"]
            else:
                lo, hi = 1 - DISPATCH_TOL, 1 + DISPATCH_TOL
                ratio = rep["flops"] / port_flops(cfg, kind, 2, 64)
            assert lo <= ratio <= hi, (kind, quantized, ratio)
            assert rep["step_kind"] == kind and rep["quantized"] == quantized
            assert rep["bound_s"] == max(rep["compute_s"], rep["memory_s"]) > 0
            assert rep["fits_one_card"] and rep["weight_bytes"] > 0
            if kind == "train":
                assert rep["cache_bytes"] == 0 and rep["bytes"] == 2 * rep["weight_bytes"]
            else:
                assert rep["cache_bytes"] > 0
    # the int8 store's weights are ~a quarter of the f32 ones
    f32 = dryrun.dry_run(cfg, shapes.InputShape("d", "decode", 64, 2))
    q = dryrun.dry_run(cfg, shapes.InputShape("d", "decode", 64, 2), quantized=True)
    assert q["weight_bytes"] < 0.5 * f32["weight_bytes"]


def test_decode_bytes_and_bound():
    """A decode step reads the weights and the cache and writes one
    position a lane; its bound is bytes over the HBM rate."""
    cfg = smoke_variant(get_config("qwen2.5-3b")).replace(dtype_name="bfloat16")
    rep = dryrun.dry_run(cfg, shapes.InputShape("d", "decode", 96, 8))
    per_token = 2 * cfg.num_layers * 8 * cfg.num_kv_heads * cfg.head_dim * 2
    assert rep["write_bytes"] == per_token
    assert rep["cache_bytes"] == per_token * 96 + cfg.num_layers * 8 * 4   # + len counters
    assert rep["bytes"] == rep["weight_bytes"] + rep["cache_bytes"] + rep["write_bytes"]
    hbm = roofline.CARD_PEAKS["H100"][0]
    assert rep["memory_s"] == rep["bytes"] / hbm and rep["dominant"] == "memory"
    assert rep["compute_s"] == rep["flops"] / roofline.CARD_PEAKS["H100"][2]


def test_one_choice_of_card_sets_peaks_and_memory(monkeypatch):
    """The card is picked once, by device name (an H100 80GB with no card
    present), and sets both the report's peaks and its memory limit."""
    assert roofline.card_key("NVIDIA H100 80GB HBM3") == "H100"
    assert roofline.card_key("NVIDIA H200") == "H200"
    assert roofline.card_key("NVIDIA A100-SXM4-80GB") is None
    if not torch.cuda.is_available():
        assert roofline.present_card() == ("H100", 80 * 2**30,
                                           "80 GiB (H100 80GB; no card present)")
    monkeypatch.setattr(roofline, "present_card", lambda: ("H200", 141 * 10**9, "an H200"))
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    rep = dryrun.dry_run(cfg, shapes.InputShape("d", "decode", 64, 2))
    assert (rep["card"], rep["card_bytes"], rep["card_bytes_source"]) == \
        ("H200", 141 * 10**9, "an H200")
    assert rep["memory_s"] == rep["bytes"] / roofline.CARD_PEAKS["H200"][0]


def test_main_reports_every_combo_and_its_errors(tmp_path, capsys, monkeypatch):
    """The CLI prints one JSON line per combo and writes one file each
    under ``--out``; MLA with a sliding window (long_500k's variant) runs
    on its latent ring: a report whose cache is 27 x 4,096 slots of 512 +
    64 bf16, whose flops are the port's own products over them, and
    whose bound is the larger roofline term; a combination that raises is
    reported with its error and sets the exit code; ``--out`` under
    benchmarks/ is refused."""
    assert dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    rep = json.loads(capsys.readouterr().out.strip())
    assert rep["arch"] == "mamba2-130m" and rep["step_kind"] == "decode"
    assert rep["card_bytes_source"].startswith("80 GiB") or torch.cuda.is_available()
    assert json.loads((tmp_path / "mamba2-130m__long_500k.json").read_text()) == rep
    assert dryrun.main(["--arch", "deepseek-v2-lite-16b", "--shape", "long_500k"]) == 0
    mla = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg, _ = shapes.adapt_config(get_config("deepseek-v2-lite-16b"), shapes.SHAPES["long_500k"])
    assert "error" not in mla and mla["step_kind"] == "decode" and cfg.window == 4096
    assert mla["cache_bytes"] == cfg.num_layers * 4096 * (512 + 64) * 2 + 4 * cfg.num_layers
    assert mla["flops"] == pytest.approx(port_flops(cfg, "decode", 1, 4096), rel=DISPATCH_TOL)
    assert mla["bound_s"] == max(mla["compute_s"], mla["memory_s"]) > 0
    assert mla["fits_one_card"]

    def refused(arch, shape, quantized=False):
        raise NotImplementedError(f"{arch} at {shape}")

    monkeypatch.setattr(dryrun, "run_combo", refused)
    assert dryrun.main(["--arch", "deepseek-v2-lite-16b", "--shape", "long_500k"]) == 1
    bad = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert bad["error"].startswith("NotImplementedError")
    with pytest.raises(SystemExit):
        dryrun.main(["--all", "--out", str(tmp_path / "benchmarks" / "x")])
