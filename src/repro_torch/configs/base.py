"""Config system of the PyTorch port: the same frozen dataclass and
registry as ``repro.configs.base``, with ``dtype`` resolving to a torch
dtype.  Kept as a copy (not an import) because the JAX module imports
jax at load time; field names and defaults must stay identical so a
config means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                       # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    mlp_type: str = "swiglu"             # swiglu | squared_relu
    attn_bias: bool = False
    norm_layernorm: bool = False         # True: LayerNorm (musicgen); else RMS
    rope_theta: float = 10000.0
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                      # sliding/local attention window (0=full)
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_renormalize: bool = True
    moe_aux_weight: float = 0.01
    moe_capacity_factor: float = 1.25
    # MLA (DeepSeek-V2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    rope_head_dim: int = 64
    v_head_dim: int = 128
    # SSM / recurrent
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    lru_width: int = 0
    # modality frontend (stub — embeddings arrive precomputed)
    frontend: str = "none"               # none | audio | vision
    num_patches: int = 256               # vision prefix length
    # numerics / engineering
    dtype_name: str = "bfloat16"
    q_chunk: int = 512
    remat: bool = True
    # distribution knobs of the JAX package (no effect in the port)
    seq_sharded_acts: bool = False
    fsdp: bool = False
    pin_acts: bool = False
    # numerics knobs
    norm_bf16_apply: bool = False        # rms_norm: stats in f32, apply in the input dtype
    kv_cache_int8: bool = False          # int8 K/V with a scale a (token, head)
    # citation
    source: str = ""

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_name)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256, as in the JAX package;
        logits at padded ids are masked to -1e9 in ``forward``."""
        return -(-self.vocab_size // 256) * 256

    @property
    def pattern_units(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        return self.layer_pattern[: self.num_layers % len(self.layer_pattern)]

    def block_kind(self, layer_idx: int) -> str:
        return self.layer_pattern[layer_idx % len(self.layer_pattern)]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---------------- parameter counting (roofline MODEL_FLOPS) ----------
    def param_counts(self) -> Dict[str, float]:
        d, v = self.d_model, self.vocab_size
        per_layer_attn = per_layer_mlp = per_layer_moe_active = per_layer_moe_total = 0.0
        per_layer_ssm = per_layer_rec = 0.0
        if "attn" in self.layer_pattern:
            if self.use_mla:
                h = self.num_heads
                per_layer_attn = (
                    d * h * (self.qk_nope_dim + self.rope_head_dim)
                    + d * (self.kv_lora_rank + self.rope_head_dim)
                    + self.kv_lora_rank * h * (self.qk_nope_dim + self.v_head_dim)
                    + h * self.v_head_dim * d
                )
            else:
                per_layer_attn = d * self.head_dim * (
                    self.num_heads * 2 + self.num_kv_heads * 2
                )
        if self.num_experts:
            per_expert = 3 * d * self.moe_d_ff
            per_layer_moe_total = self.num_experts * per_expert + d * self.num_experts
            per_layer_moe_active = self.experts_per_token * per_expert + d * self.num_experts
            shared = self.num_shared_experts * 3 * d * self.moe_d_ff
            per_layer_moe_total += shared
            per_layer_moe_active += shared
        elif self.d_ff:
            mult = 3 if self.mlp_type == "swiglu" else 2
            per_layer_mlp = mult * d * self.d_ff
        if "ssm" in self.layer_pattern:
            di = self.ssm_expand * d
            per_layer_ssm = d * (2 * di + 2 * self.ssm_state + di // self.ssm_head_dim) + di * d
        if "rec" in self.layer_pattern:
            w = self.lru_width
            per_layer_rec = d * w * 2 + 2 * w * w + w * d

        total = active = 2 * v * d  # embed + head
        for i in range(self.num_layers):
            kind = self.block_kind(i)
            if kind == "attn":
                body = per_layer_attn + (per_layer_moe_total or per_layer_mlp)
                act = per_layer_attn + (per_layer_moe_active or per_layer_mlp)
            elif kind == "ssm":
                body = act = per_layer_ssm
            else:  # rec
                body = per_layer_rec + per_layer_mlp
                act = body
            total += body
            active += act
        return {"total": float(total), "active": float(active)}


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # import the configs package so registration side effects run
    import repro_torch.configs  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401

    return tuple(sorted(_REGISTRY))


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers (pattern-preserving), small dims."""
    pattern = cfg.layer_pattern
    n_layers = max(2, len(pattern))
    d = min(cfg.d_model, 256)
    kw: Dict[str, Any] = dict(
        num_layers=n_layers,
        d_model=d,
        vocab_size=min(cfg.vocab_size, 512),
        dtype_name="float32",
        remat=False,
        q_chunk=64,
        ssm_chunk=16,
    )
    if cfg.num_heads:
        heads = min(cfg.num_heads, 4)
        kv = max(1, min(cfg.num_kv_heads, heads))
        kw.update(num_heads=heads, num_kv_heads=kv, head_dim=d // heads)
    if cfg.d_ff:
        kw.update(d_ff=min(cfg.d_ff, 4 * d))
    if cfg.num_experts:
        kw.update(num_experts=4, experts_per_token=2,
                  num_shared_experts=min(cfg.num_shared_experts, 1),
                  moe_d_ff=min(cfg.moe_d_ff, d),
                  moe_capacity_factor=4.0)  # drop-free at smoke scale
    if cfg.use_mla:
        kw.update(kv_lora_rank=64, qk_nope_dim=32, rope_head_dim=16, v_head_dim=32,
                  head_dim=0)
        kw["num_heads"] = 4
        kw["num_kv_heads"] = 4
    if cfg.ssm_state:
        kw.update(ssm_state=min(cfg.ssm_state, 32), ssm_head_dim=32)
    if cfg.lru_width:
        kw.update(lru_width=d)
    if cfg.window:
        kw.update(window=min(cfg.window, 32))
    if cfg.frontend == "vision":
        kw.update(num_patches=8)
    return cfg.replace(name=cfg.name + "-smoke", **kw)
