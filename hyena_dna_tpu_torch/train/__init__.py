"""Training: optimizer, state and the train/eval steps."""

from hyena_dna_tpu_torch.train.optim import build_optimizer, label_params
from hyena_dna_tpu_torch.train.state import TrainState, create_train_state
from hyena_dna_tpu_torch.train.step import (make_eval_step, make_multistep_train_step,
                                            make_train_step)

__all__ = ["build_optimizer", "label_params", "TrainState", "create_train_state",
           "make_train_step", "make_eval_step", "make_multistep_train_step"]
