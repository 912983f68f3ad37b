"""Selective-scan ops: plain-torch reference, CUDA kernel wrappers (autograd
Functions whose backward is a kernel too), routing, and the cross-scan
layout ops; and the LayerNorm kernel's wrapper for the forward without a
gradient."""

from .cross_scan import cross_merge, cross_scan
from .layer_norm import layer_norm, layer_norm_plain
from .linear_recurrence import (
    linear_recurrence,
    linear_recurrence_plain,
    linear_recurrence_reverse,
    linear_recurrence_reverse_plain,
)
from .scan_api import selective_scan
from .seq_scan import seq_sharded_selective_scan
from .selective_scan_fused import (
    fused_chunk_states_plain,
    selective_scan_fused,
    selective_scan_fused_bwd,
    selective_scan_fused_bwd_plain,
    selective_scan_fused_fwd,
    selective_scan_fused_plain,
)
from .selective_scan_nstate import selective_scan_nstate, selective_scan_nstate_plain
from .selective_scan_ref import linear_recurrence_ref, selective_scan_ref, softplus

__all__ = [
    "cross_merge",
    "cross_scan",
    "layer_norm",
    "layer_norm_plain",
    "fused_chunk_states_plain",
    "linear_recurrence",
    "linear_recurrence_plain",
    "linear_recurrence_ref",
    "linear_recurrence_reverse",
    "linear_recurrence_reverse_plain",
    "selective_scan",
    "selective_scan_fused",
    "selective_scan_fused_bwd",
    "selective_scan_fused_bwd_plain",
    "selective_scan_fused_fwd",
    "selective_scan_fused_plain",
    "selective_scan_nstate",
    "selective_scan_nstate_plain",
    "selective_scan_ref",
    "seq_sharded_selective_scan",
    "softplus",
]
