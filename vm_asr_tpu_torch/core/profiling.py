"""FLOP counters, parameter counts, finiteness guards, tracing and honest
timing (port of vm_asr_tpu/core/profiling.py).

``matmul_flops`` counts the FLOPs of a call's matrix products and
convolutions from their shapes, in the JAX package's convention (its jaxpr
walk), so that the two packages' counts of one model are equal.
``model_flops`` adds the selective scan's analytic count. XLA's cost
analysis has no counterpart here and is not ported.

``median_window_dt`` times N and 2N chained calls and takes (T_2N − T_N)/N,
which cancels every per-window constant (the synchronisation, the first
calls' ramp). On the card each window is timed by CUDA events and ends in
``torch.cuda.synchronize()``; on the CPU by ``time.perf_counter``.

Spans: ``span(name, **counts)`` marks a phase of a request or a step (the
Inferencer's and the train step's phases, the Trainer's loop). It records
only while a ``torch.profiler`` is collecting; otherwise it is one check
and a shared no-op object. ``add_counts(**counts)`` adds to the counts of
the innermost span open (a bucket forward's graph replay). A recorded span
is a ``Span`` on ``time.time_ns()``, the clock of the profiler's events, and a
``record_function`` range named ``vmasr/<name>`` in the profiler's trace.
``recorded_spans()`` reads them, ``clear_spans()`` drops them;
``device_intervals`` reads a finished profiler's kernels and copies, and
``busy_ns`` and ``idle_by_span`` take the device's busy time and its idle
time by the innermost span open.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch._C._autograd import _profiler_enabled
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode


def flops_selective_scan(b: int, l: int, d: int, n: int, with_d: bool = True,
                         with_z: bool = False) -> int:
    """Analytic FLOPs of the selective scan, the reference's fvcore handler
    (vmamba.py:172-195): 9·B·L·D·N for the recurrence and its einsums, plus
    the D skip and the gate."""
    flops = 9 * b * l * d * n
    if with_d:
        flops += b * d * l
    if with_z:
        flops += b * d * l
    return flops


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
    (torch's own output is larger: models/layers.py:ConvTranspose2d crops
    it). Depthwise convolutions count nothing (see ``matmul_flops``)."""
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
    """FLOPs of the matrix products and convolutions of one call
    ``fn(*args)``, counted from their shapes under a ``TorchDispatchMode``:
    ``aten.mm/addmm/bmm/baddbmm`` as 2·M·N·K (times the batch),
    ``aten.convolution`` as 2·prod(out)·C_in-per-group·K_spatial and a
    two-operand ``torch.einsum`` as the ``dot_general`` it is in JAX, the JAX
    package's convention (vm_asr_tpu/core/profiling.py:matmul_flops), so
    that both packages count one model alike. Two exceptions keep them
    equal:

    - a depthwise convolution (groups == C_in == C_out) counts nothing: the
      JAX package writes it as shifted multiply-adds, no convolution, and
      on an H100 it runs on the CUDA cores, not the tensor cores;
    - a transposed convolution counts over stride × its input's size, the
      output of JAX's lhs-dilated convolution at "SAME" padding, not over
      its input as ``torch.utils.flop_counter`` counts it.

    The scans' kernels and plain versions and the FFTs count nothing, as
    the Pallas kernels and ``jnp.fft`` count nothing in JAX. This is the
    numerator of a tensor-core utilisation."""
    counter = _FlopCounter()
    # Inference mode would hand the mode composite ops (aten.linear,
    # aten.matmul) undecomposed: count outside it, in the caller's grad mode.
    grad = torch.is_grad_enabled()
    with torch.inference_mode(False), torch.set_grad_enabled(grad), \
            _EinsumCounter(counter), counter:
        fn(*args)
    return counter.flops


def model_flops(model: torch.nn.Module, *args) -> Dict[str, float]:
    """GFLOPs of one forward ``model(*args)`` (a generator's (x, hf), a
    classifier's image): ``matmul_flops`` plus ``flops_selective_scan`` of
    every SS2D's scan at the shapes it meets (B, L, K·D, N). The JAX
    package also reports XLA's bytes accessed; torch has no such count, so
    that key is left out."""
    from ..models.ss2d import SS2D

    scans = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: scans.append(flops_selective_scan(
            inp[0].shape[0], inp[0].shape[1] * inp[0].shape[2],
            mod.k_group * mod.d_inner, mod.d_state)))
        for m in model.modules() if isinstance(m, SS2D)]
    try:
        with torch.no_grad():
            mm = matmul_flops(model, *args)
    finally:
        for h in hooks:
            h.remove()
    return {"gflops": (mm + sum(scans)) / 1e9, "matmul_gflops": mm / 1e9,
            "scan_gflops": sum(scans) / 1e9}


def count_params(params: Any) -> int:
    """Elements in a module's parameters, or in an iterable of tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    return sum(p.numel() for p in params)


def _leaves(tree: Any, path: str = "") -> Iterable[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def tree_check_finite(tree: Any) -> Tuple[bool, list]:
    """Finiteness of every tensor, array or number in a nested dict / list
    (one host transfer per leaf); returns (ok, bad paths)."""
    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            ok = bool(torch.isfinite(leaf).all())
        else:
            ok = bool(np.isfinite(np.asarray(leaf)).all())
        if not ok:
            bad.append(path)
    return (len(bad) == 0, bad)


def assert_finite(tree: Any, what: str = "tree") -> None:
    ok, bad = tree_check_finite(tree)
    if not ok:
        raise FloatingPointError(f"Non-finite values in {what}: {bad[:8]}")


def _first_tensor(tree: Any):
    return next((leaf for _, leaf in _leaves(tree) if isinstance(leaf, torch.Tensor)), None)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` over the block (the CPU, and the card where there
    is one), its Chrome trace written to ``log_dir/trace.json``; yields the
    profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


SPAN_PREFIX = "vmasr/"


class Span(NamedTuple):
    """One recorded phase. ``parent`` is the enclosing span's ``id`` (0 for
    an outermost span); ``group`` is the id of the outermost span it lies in,
    the request or step it belongs to. Times are ``time.time_ns()``, the
    clock the profiler's events carry. ``counts``: the keywords given to
    ``span``."""

    name: str
    id: int
    parent: int
    group: int
    start_ns: int
    end_ns: int
    counts: dict


class _Off:
    """The span of a call made while no profiler collects: nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_SPANS: List[Span] = []
_IDS = itertools.count(1)
_OPEN = threading.local()  # each thread's stack of open spans


class _On:
    __slots__ = ("name", "counts", "id", "parent", "group", "start_ns", "range")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self):
        stack = _OPEN.__dict__.setdefault("stack", [])
        self.id = next(_IDS)
        self.parent, self.group = (stack[-1].id, stack[-1].group) if stack else (0, self.id)
        stack.append(self)
        self.range = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self.start_ns = time.time_ns()
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end = time.time_ns()
        _OPEN.stack.pop()
        _SPANS.append(Span(self.name, self.id, self.parent, self.group, self.start_ns, end,
                           self.counts))
        return False


def span(name: str, **counts):
    """A context manager over one phase ``name`` of the calling thread. While
    a ``torch.profiler`` collects, it records a ``Span`` (with ``counts``)
    and enters ``record_function("vmasr/" + name)``; otherwise it returns
    one shared object that does nothing."""
    if not _profiler_enabled():
        return _OFF
    return _On(name, counts)


def add_counts(**counts: int) -> None:
    """Add ``counts`` to those of the innermost span the calling thread has
    open, while a profiler collects; nothing otherwise."""
    if not _profiler_enabled():
        return
    stack = getattr(_OPEN, "stack", None)
    if stack:
        into = stack[-1].counts
        for k, v in counts.items():
            into[k] = into.get(k, 0) + v


def recorded_spans() -> List[Span]:
    """The spans recorded so far, in the order they ended (not cleared)."""
    return list(_SPANS)


def clear_spans() -> None:
    _SPANS.clear()


def device_intervals(prof) -> List[Tuple[int, int]]:
    """(start ns, end ns) of every kernel and copy a finished profiler saw on
    the card, sorted; the annotations the profiler mirrors onto the device
    are left out. Read from the raw events: ``prof.events()`` builds a tree
    of every host op, which takes tens of seconds for a few training steps."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation() \
                and e.end_ns() > e.start_ns():
            out.append((e.start_ns(), e.end_ns()))
    return sorted(out)


def _merged(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    """Length of the union of the intervals."""
    return sum(e - s for s, e in _merged(intervals))


def _innermost(spans: List[Span], start: int, end: int) -> List[Tuple[int, int, str]]:
    """[start, end] cut into pieces, each named by the innermost span open
    over it (the latest to start; of those, the first to end), "outside"
    where none is."""
    cuts = sorted({start, end, *(t for s in spans for t in (s.start_ns, s.end_ns)
                                 if start < t < end)})
    pieces = []
    for a, b in zip(cuts, cuts[1:]):
        open_ = [(s.start_ns, -s.end_ns, s.name) for s in spans
                 if s.start_ns <= a and s.end_ns >= b]
        pieces.append((a, b, max(open_)[2] if open_ else "outside"))
    return pieces


def idle_by_span(intervals: Iterable[Tuple[int, int]], spans: List[Span], start: int,
                 end: int) -> Dict[str, int]:
    """The card's idle ns within [start, end] by span name: each idle ns goes
    to the innermost span open at that ns ("outside" where none is), so a
    gap that crosses spans is split between them."""
    pieces = _innermost(spans, start, end)
    out: Dict[str, int] = {}
    t, i = start, 0

    def give(a, b):
        nonlocal i
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            lo, hi = max(a, pieces[j][0]), min(b, pieces[j][1])
            if hi > lo:
                out[pieces[j][2]] = out.get(pieces[j][2], 0) + hi - lo
            j += 1

    for s, e in _merged(intervals):
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if s > t:
            give(t, s)
        t = max(t, e)
    if end > t:
        give(t, end)
    return out


def debug_nan_context():
    """Anomaly detection that raises at the backward op that made a NaN
    (``torch.autograd.detect_anomaly(check_nan=True)``; JAX: debug_nans)."""
    return torch.autograd.detect_anomaly(check_nan=True)


def median_window_dt(step: Callable, state: Any, iters: int, windows: int = 3):
    """Seconds per call of ``step(state) -> state``, by differential windows.

    Each window runs ``iters`` and then ``2·iters`` chained calls and takes
    (T_2N − T_N)/N; the median over ``windows`` windows is returned with the
    last state. The device is that of the first tensor in ``state``: on a
    card the windows are timed by CUDA events and end in a synchronise, on
    the CPU by the host clock. ``step`` must feed its output into the next
    call, so that the calls are ordered and each one's work is consumed.
    """
    first = _first_tensor(state)
    cuda = first is not None and first.is_cuda

    def run(n, s):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                s = step(s)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / 1e3, s
        t0 = time.perf_counter()
        for _ in range(n):
            s = step(s)
        return time.perf_counter() - t0, s

    dts, mean_rates = [], []
    for _ in range(windows):
        t_n, state = run(iters, state)
        t_2n, state = run(2 * iters, state)
        dts.append((t_2n - t_n) / iters)
        mean_rates.append(t_2n / (2 * iters))
    dt = float(np.median(dts))
    if dt <= 0.0:
        # Noise above the call's cost: the least mean rate, which includes
        # the per-window constant and so bounds the call from above.
        dt = float(np.min(mean_rates))
    return dt, state


def benchmark(fn: Callable, *args, iters: int = 20, warmup: int = 2,
              chain: Callable = None) -> Dict[str, float]:
    """Seconds per call of ``fn(*args)`` by :func:`median_window_dt`, after a
    first call and ``warmup`` more. ``chain(out, *args) -> new_args`` feeds
    each call's output into the next call's inputs; without it the same
    arguments are passed again."""
    cur = args
    out = fn(*cur)
    for _ in range(warmup):
        if chain is not None:
            cur = chain(out, *cur)
        out = fn(*cur)

    def step(state):
        out_, cur_ = state
        if chain is not None:
            cur_ = chain(out_, *cur_)
        return (fn(*cur_), cur_)

    dt, _ = median_window_dt(step, (out, cur), iters=iters)
    return {"seconds_per_call": dt, "calls_per_second": 1.0 / dt}
