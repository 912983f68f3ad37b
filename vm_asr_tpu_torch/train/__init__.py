from .inferencer import Inferencer
from .optim import Optimizer, make_optimizer, make_schedule
from .states import DiscState, GenState
from .steps import (
    SEG_BUCKETS,
    bucketed_forward,
    make_eval_step,
    make_forward_fn,
    make_train_step,
    segment_bucket_counts,
)
from .tester import Tester
from .trainer import Trainer

__all__ = ["DiscState", "GenState", "Inferencer", "Optimizer", "SEG_BUCKETS", "Tester",
           "Trainer", "bucketed_forward", "make_eval_step", "make_forward_fn",
           "make_optimizer", "make_schedule", "make_train_step", "segment_bucket_counts"]
