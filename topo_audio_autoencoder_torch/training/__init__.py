"""Training layer: objective, steps and optimizer, trainer shell,
vmapped grid tuner, checkpointing."""

from .losses import LossWeights, autoencoder_loss
from .metrics import MetricWriter, TrainingMetrics
from .checkpoint import CheckpointManager
from .train_step import (
    Optimizer,
    OptState,
    TrainState,
    anneal_temperature,
    component_grad_norms,
    create_train_state,
    make_eval_step,
    make_indexed_train_step,
    make_loss_and_grads,
    make_optimizer,
    make_scan_indexed_train_step,
    make_scan_train_step,
    make_sharded_corpus_gather,
    make_train_step,
)
from .trainer import Trainer, TrainerConfig
from .tuner import GridState, VmappedGridTuner

__all__ = [
    "CheckpointManager",
    "GridState",
    "LossWeights",
    "MetricWriter",
    "OptState",
    "Optimizer",
    "TrainState",
    "Trainer",
    "TrainerConfig",
    "TrainingMetrics",
    "VmappedGridTuner",
    "anneal_temperature",
    "autoencoder_loss",
    "component_grad_norms",
    "create_train_state",
    "make_eval_step",
    "make_indexed_train_step",
    "make_loss_and_grads",
    "make_optimizer",
    "make_scan_indexed_train_step",
    "make_scan_train_step",
    "make_sharded_corpus_gather",
    "make_train_step",
]
