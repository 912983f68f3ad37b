"""FLOPs of a call's matrix products and convolutions, counted from their
shapes under a ``TorchDispatchMode`` (copied from the port's
``core/profiling.py:matmul_flops``, which counts in the JAX package's
convention): ``aten.mm/addmm/bmm/baddbmm`` as 2·M·N·K (times the batch),
``aten.convolution`` as 2·prod(out)·C_in-per-group·K_spatial, a two-operand
``torch.einsum`` as 2 × the product of every index's size; depthwise
convolutions, FFTs and the scans count nothing. It runs on the benchmark's
reference, on the meta device, so that the count does not depend on what
implements the work, and backward passes are counted like forward ones.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten
_MATMULS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default)


def _matmul_count(func, args, out) -> int:
    if func in (_aten.mm.default, _aten.bmm.default):
        a, b = args[0], args[1]
    else:  # addmm / baddbmm: (bias, a, b)
        a, b = args[1], args[2]
    batch = a.shape[0] if a.dim() == 3 else 1
    m, k = a.shape[-2], a.shape[-1]
    return 2 * batch * m * b.shape[-1] * k


def _conv_count(args, out) -> int:
    """2·prod(out)·C_in-per-group·K_spatial, JAX's ``conv_general_dilated``
    count. A transposed convolution is counted as JAX counts it, the
    lhs-dilated convolution over its output, which at the "SAME" padding of
    every transposed conv in the models is stride × the input's size
    (torch's own output is larger, and the port crops it). Depthwise
    convolutions count nothing."""
    x, w = args[0], args[1]
    stride, transposed, groups = args[3], args[6], args[8]
    c_in, c_out = x.shape[1], out.shape[1]
    if groups == c_in == c_out and groups > 1:
        return 0
    k_spatial = int(np.prod(w.shape[2:], dtype=np.int64))
    if transposed:
        spatial = [s * n for s, n in zip(stride, x.shape[2:])]
        return 2 * x.shape[0] * c_out * int(np.prod(spatial, dtype=np.int64)) \
            * (c_in // groups) * k_spatial
    return 2 * int(np.prod(out.shape, dtype=np.int64)) * w.shape[1] * k_spatial


def _conv_backward_count(args) -> int:
    """A convolution's backward: the forward's count once for the input's
    gradient and once for the weight's, as each is asked for (the mask);
    the bias's gradient is a sum and counts nothing."""
    grad_out, x, w = args[0], args[1], args[2]
    stride, padding, dilation, transposed, out_pad, groups, mask = args[4:11]
    if transposed:
        raise NotImplementedError("no transposed convolution is differentiated here")
    fwd = (x, w, None, stride, padding, dilation, transposed, out_pad, groups)
    return _conv_count(fwd, grad_out) * (int(mask[0]) + int(mask[1]))


def _einsum_count(args) -> Optional[int]:
    """A two-operand einsum as JAX counts its ``dot_general``: 2 × the
    product of every index's size (batch, free and contracted alike). None
    for any other einsum, whose pairwise products aten counts one by one,
    as JAX counts the ``dot_general`` of each pair."""
    spec, *ops = args
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = ops[0]
    if len(ops) != 2:
        return None
    sizes = {}
    for term, t in zip(spec.replace(" ", "").split("->")[0].split(","), ops):
        sizes.update(zip(term, t.shape))
    return 2 * int(np.prod(list(sizes.values()), dtype=np.int64))


class _FlopCounter(TorchDispatchMode):
    """Counts the aten products and convolutions of the calls it sees, but
    those inside an einsum, which ``_EinsumCounter`` counts whole."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.in_einsum = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.in_einsum:
            return out
        if func in _MATMULS:
            self.flops += _matmul_count(func, args, out)
        elif func is _aten.convolution.default:
            self.flops += _conv_count(args, out)
        elif func is _aten.convolution_backward.default:
            self.flops += _conv_backward_count(args)
        return out


class _EinsumCounter(TorchFunctionMode):
    """torch.einsum counted from its operands: a contraction over an index
    of size 1 (the dt projection at dt_rank 1) reaches aten as a broadcast
    multiply, while JAX's einsum is a ``dot_general`` whatever the sizes."""

    def __init__(self, counter: _FlopCounter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        flops = None
        if func is torch.einsum and not self.counter.in_einsum:
            flops = _einsum_count(args)
        if flops is None:
            return func(*args, **(kwargs or {}))
        self.counter.flops += flops
        self.counter.in_einsum = True
        try:
            return func(*args, **(kwargs or {}))
        finally:
            self.counter.in_einsum = False


def matmul_flops(fn: Callable, *args) -> int:
    """FLOPs of the products and convolutions of one call ``fn(*args)``,
    in the caller's grad mode (never inference mode, which would hand the
    mode composite ops undecomposed)."""
    counter = _FlopCounter()
    grad = torch.is_grad_enabled()
    with torch.inference_mode(False), torch.set_grad_enabled(grad), \
            _EinsumCounter(counter), counter:
        fn(*args)
    return counter.flops
