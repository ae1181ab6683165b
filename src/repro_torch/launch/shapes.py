"""The assigned input shapes and their step inputs on the ``meta`` device.

Counterpart of ``repro/launch/shapes.py``: the same four shapes and the
same per-shape config adaptation.  ``input_specs(cfg, shape)`` returns
(step kind, kwargs) whose tensors live on ``meta`` (shapes and dtypes,
no storage), the port's stand-in for the JAX package's
``ShapeDtypeStruct``\\ s: the dry run (``launch/dryrun.py``) runs the
real step functions on them.

``long_500k`` needs sub-quadratic attention: the SSM and hybrid models
run natively, full-attention models their sliding-window variant
(window 4096), a config flag, so the KV cache is window-sized; the
variant is named in the note :func:`adapt_config` returns.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib

SWA_WINDOW = 4096


@dataclass(frozen=True)
class InputShape:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}


def adapt_config(cfg: ModelConfig, shape: InputShape) -> Tuple[ModelConfig, str]:
    """Per-shape config adaptation (returns (cfg, note))."""
    note = ""
    if shape.name == "long_500k" and cfg.window == 0 and "attn" in cfg.layer_pattern:
        cfg = cfg.replace(window=SWA_WINDOW)
        note = f"sliding-window variant (window={SWA_WINDOW}) for 500k decode"
    if shape.kind == "train" and shape.seq_len >= 32_768:
        cfg = cfg.replace(q_chunk=512)
    return cfg, note


def token_spec(batch: int, seq: int, device="meta") -> torch.Tensor:
    return torch.empty((batch, seq), dtype=torch.int32, device=device)


def input_specs(cfg: ModelConfig, shape: InputShape,
                device="meta") -> Tuple[str, Dict[str, Any]]:
    """(kind, kwargs) for the step this shape runs, every tensor on
    ``device``: ``train`` {"batch": {tokens, labels[, patch_embeds]}}
    for ``lm_loss``; ``prefill`` {tokens, cache[, patch_embeds]} for
    ``engine.prefill_step``; ``decode`` {tokens (B, 1), cache, pos} for
    ``engine.serve_step``, ``pos`` (B,) int32 (the JAX package's is a
    scalar).  A vision model's P patch positions come out of the
    sequence, so the step still covers ``seq_len`` positions."""
    b, s = shape.batch, shape.seq_len
    vlm = cfg.frontend == "vision"
    p = cfg.num_patches if vlm else 0

    def patches():
        return torch.empty((b, p, cfg.d_model), dtype=cfg.dtype, device=device)

    if shape.kind == "train":
        batch = {"tokens": token_spec(b, s - p, device),
                 "labels": token_spec(b, s - p, device)}
        if vlm:
            batch["patch_embeds"] = patches()
        return "train", {"batch": batch}

    cache = model_lib.init_cache(cfg, b, s, device=device)
    if shape.kind == "prefill":
        spec: Dict[str, Any] = {"tokens": token_spec(b, s - p, device), "cache": cache}
        if vlm:
            spec["patch_embeds"] = patches()
        return "prefill", spec

    # decode: ONE token against a seq_len cache
    return "decode", {"tokens": token_spec(b, 1, device), "cache": cache,
                      "pos": torch.empty((b,), dtype=torch.int32, device=device)}
