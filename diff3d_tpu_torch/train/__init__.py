from diff3d_tpu_torch.train.checkpoint import (CheckpointManager,
                                               CheckpointMismatchError)
from diff3d_tpu_torch.train.distill import (DistillDraws, DistillStep,
                                            distill, distill_schedule,
                                            make_distill_step, start_round)
from diff3d_tpu_torch.train.state import (TrainState, create_train_state,
                                          ema_decay_per_step, make_optimizer,
                                          set_schedule_step, settle_lr,
                                          warmup_schedule)
from diff3d_tpu_torch.train.step import make_train_step
from diff3d_tpu_torch.train.trainer import (ELASTIC_GAVE_UP,
                                            ELASTIC_REMESHING,
                                            ELASTIC_RESUMED, ELASTIC_RUNNING,
                                            ElasticEvent, ElasticityGaveUp,
                                            ElasticSupervisor, Trainer,
                                            init_params)

__all__ = ["CheckpointManager", "CheckpointMismatchError", "DistillDraws",
           "DistillStep", "ELASTIC_GAVE_UP", "ELASTIC_REMESHING",
           "ELASTIC_RESUMED", "ELASTIC_RUNNING", "ElasticEvent",
           "ElasticSupervisor", "ElasticityGaveUp", "TrainState", "Trainer", "create_train_state",
           "distill", "distill_schedule", "ema_decay_per_step",
           "init_params", "make_distill_step", "make_optimizer",
           "make_train_step", "set_schedule_step", "settle_lr",
           "start_round", "warmup_schedule"]
