"""Parameter counts, finiteness guards and honest timing (port of
vm_asr_tpu/core/profiling.py:123-236).

``median_window_dt`` times N and 2N chained calls and takes (T_2N − T_N)/N,
which cancels every per-window constant (the synchronisation, the first
calls' ramp). On the card each window is timed by CUDA events and ends in
``torch.cuda.synchronize()``; on the CPU by ``time.perf_counter``. The JAX
package's jaxpr and XLA FLOP counters are not ported yet.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Tuple

import numpy as np
import torch


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
