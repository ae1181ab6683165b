"""Synthetic data: the paper MLP's classification task + LM token streams."""
from repro_torch.data.pipeline import LMDataConfig, classification_data, lm_batches

__all__ = ["LMDataConfig", "classification_data", "lm_batches"]
