"""Training slice of the port: the optimizers, the step, the trainer and
checkpoints."""
from .checkpoint import (AsyncSaver, adapt_vocab_params, checkpoint_suffix,
                         find_checkpoint, load_checkpoint, save_checkpoint)
from .optimizer import (GROUPS, FusedOptimizer, GradientTransform, GroupLRs,
                        ReduceLROnPlateau)
from .train_step import (DynamicScalars, TrainState, compute_losses,
                         make_eval_step, make_train_step)
from .trainer import SmartContractTrainer

__all__ = ["GROUPS", "AsyncSaver", "DynamicScalars", "FusedOptimizer",
           "GradientTransform", "GroupLRs", "ReduceLROnPlateau",
           "SmartContractTrainer", "TrainState", "adapt_vocab_params",
           "checkpoint_suffix", "compute_losses", "find_checkpoint",
           "load_checkpoint", "make_eval_step", "make_train_step",
           "save_checkpoint"]
