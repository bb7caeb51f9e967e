from diff3d_tpu_torch.train.checkpoint import CheckpointManager
from diff3d_tpu_torch.train.state import (TrainState, create_train_state,
                                          ema_decay_per_step, make_optimizer,
                                          set_schedule_step, settle_lr,
                                          warmup_schedule)
from diff3d_tpu_torch.train.step import make_train_step
from diff3d_tpu_torch.train.trainer import Trainer, init_params

__all__ = ["CheckpointManager", "TrainState", "Trainer", "create_train_state",
           "ema_decay_per_step", "init_params", "make_optimizer",
           "make_train_step", "set_schedule_step", "settle_lr",
           "warmup_schedule"]
