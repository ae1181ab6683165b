"""Core of the port: the compression pipeline (prune, int8, weight
sharing), licensing math and Algorithm 1, the flat layer-name view of a
parameter tree, and the update path's server and wire (the JAX package's
``repro.core`` counterparts): the versioned ``WeightStore``, the sparse
delta encode/apply, the ``LicenseServer`` / ``EdgeClient`` protocol and
the fault-tolerant transport."""
from repro_torch.core.compression import (CompressionStats, QuantizedTensor, SharedTensor,
                                          compress_pipeline, dequantize, is_dynamics_param,
                                          magnitude_prune, prune_params, quantize_int8,
                                          unshare, weight_share)
from repro_torch.core.delta import apply_packet, encode_delta, shard_delta
from repro_torch.core.licensing import (FULL_TIER, CalibrationStep, LicenseTier,
                                        apply_license, calibrate_license,
                                        interval_mask, license_stats,
                                        magnitude_quantiles, make_static_tiers,
                                        mask_weight)
from repro_torch.core.protocol import EdgeClient, LicenseServer
from repro_torch.core.pytree_io import flatten_params, unflatten, unflatten_like
from repro_torch.core.transport import (ChaosTransport, DirectTransport, RetryPolicy,
                                        Transport)
from repro_torch.core.weightstore import LayerDelta, UpdatePacket, WeightStore

__all__ = ["CompressionStats", "QuantizedTensor", "SharedTensor", "compress_pipeline",
           "dequantize", "magnitude_prune", "prune_params", "quantize_int8", "unshare",
           "weight_share", "is_dynamics_param", "apply_packet", "encode_delta",
           "shard_delta", "FULL_TIER",
           "CalibrationStep", "LicenseTier", "apply_license", "calibrate_license",
           "interval_mask", "license_stats", "magnitude_quantiles",
           "make_static_tiers", "mask_weight",
           "EdgeClient", "LicenseServer", "flatten_params", "unflatten",
           "unflatten_like", "ChaosTransport", "DirectTransport", "RetryPolicy",
           "Transport", "LayerDelta", "UpdatePacket", "WeightStore"]
