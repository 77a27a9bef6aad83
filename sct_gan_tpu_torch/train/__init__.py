"""Training slice of the port: the fused optimizer, the step, the trainer."""
from .optimizer import FusedOptimizer, GroupLRs, ReduceLROnPlateau
from .train_step import (DynamicScalars, TrainState, compute_losses,
                         make_eval_step, make_train_step)
from .trainer import SmartContractTrainer

__all__ = ["DynamicScalars", "FusedOptimizer", "GroupLRs",
           "ReduceLROnPlateau", "SmartContractTrainer", "TrainState",
           "compute_losses", "make_eval_step", "make_train_step"]
