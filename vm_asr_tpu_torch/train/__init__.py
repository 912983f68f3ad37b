from .inferencer import Inferencer
from .steps import SEG_BUCKETS, bucketed_forward, make_forward_fn, segment_bucket_counts

__all__ = ["Inferencer", "SEG_BUCKETS", "bucketed_forward", "make_forward_fn",
           "segment_bucket_counts"]
