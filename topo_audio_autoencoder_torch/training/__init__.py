"""Training objective, optimizer and train/eval steps."""

from .losses import LossWeights, autoencoder_loss
from .train_step import (
    Optimizer,
    OptState,
    TrainState,
    anneal_temperature,
    component_grad_norms,
    create_train_state,
    make_eval_step,
    make_loss_and_grads,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "LossWeights",
    "OptState",
    "Optimizer",
    "TrainState",
    "anneal_temperature",
    "autoencoder_loss",
    "component_grad_norms",
    "create_train_state",
    "make_eval_step",
    "make_loss_and_grads",
    "make_optimizer",
    "make_train_step",
]
