"""Training: AdamW optimizer + LM/MLP train loops with versioned checkpoints.

``train_mlp``/``finetune_pruned_mlp`` cover the paper's edge MLP (train,
prune, fine-tune); ``train_loop``/``make_train_step`` the LM-scale path.
"""
from repro_torch.training.optimizer import (AdamWState, OptimizerConfig, apply_updates,
                                            init_state)
from repro_torch.training.train_lib import (
    TrainState,
    finetune_pruned_mlp,
    init_mlp_params,
    make_train_step,
    mlp_accuracy,
    mlp_forward,
    train_loop,
    train_mlp,
)

__all__ = [
    "AdamWState", "OptimizerConfig", "apply_updates", "init_state", "TrainState",
    "finetune_pruned_mlp", "init_mlp_params", "make_train_step", "mlp_accuracy",
    "mlp_forward", "train_loop", "train_mlp",
]
