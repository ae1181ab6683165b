"""Hopper kernels of the port, each beside its plain PyTorch version.

- paged_attention / paged_decode_write: CUDA C++ (``csrc/``), decode
  attention split over the context (a cp.async page ring per split, a
  fixed-order combine) and the one-token write against the block-paged
  KV pool
- masked_dequant: CUDA C++ (``csrc/``), fused int8 dequant +
  license-interval mask, one launch per stacked (U, R, C) leaf
- delta_apply / delta_apply_inplace: CUDA C++ (``csrc/``), the sparse
  weight-delta scatter of the update path; in place as
  ``delta_apply_parts``, every rows part and chunk page of a staged-sync
  step in one launch from one pinned upload
- flash_attention: CUDA C++ (``csrc/``), causal / windowed / offset
  online-softmax attention with GQA (bf16 on wgmma with a cp.async K/V
  ring, f32 on mma.sync; scores on chip)
- quant_matmul: CUDA C++ (``csrc/``), x @ (int8 codes * per-column
  scale) on the tensor cores: bf16 x by a split-K weight-stationary
  kernel at decode-sized M or by wgmma above it, f32 x on mma.sync

``ops`` holds the dispatchers and launch counters, ``ref`` the plain
versions, ``build`` the compile-at-first-use loader; ``csrc/mma.cuh`` and
``csrc/wgmma.cuh`` the tensor-core helpers the last two share.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
