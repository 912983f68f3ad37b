"""Selective-scan ops: plain-torch reference, CUDA kernel wrappers, routing,
and the cross-scan layout ops."""

from .cross_scan import cross_merge, cross_scan
from .linear_recurrence import linear_recurrence, linear_recurrence_plain
from .scan_api import selective_scan
from .selective_scan_fused import selective_scan_fused, selective_scan_fused_plain
from .selective_scan_ref import linear_recurrence_ref, selective_scan_ref, softplus

__all__ = [
    "cross_merge",
    "cross_scan",
    "linear_recurrence",
    "linear_recurrence_plain",
    "linear_recurrence_ref",
    "selective_scan",
    "selective_scan_fused",
    "selective_scan_fused_plain",
    "selective_scan_ref",
    "softplus",
]
