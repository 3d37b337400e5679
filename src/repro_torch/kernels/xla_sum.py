"""The reference's order of additions for a sum over the last axis.

``jnp.sum`` (and ``jnp.mean``) on the CPU adds left to right, starting from
the first value, for up to 32 values.  For a longer axis XLA's CPU compiler
rewrites the reduction into a tree: the row is cut into windows of exactly
:data:`SUM_WINDOW` values, the zero padding split between both ends (the
low end takes the smaller half), each window summed from 0 in order, and
the window sums reduced again by the same rule, level after level.

This is the port's one definition of that rule.  The softmax's plain twin
(``cordic_act.cordic_softmax_plain``) and the front-end's row sum
(``frontend.row_sum_plain``) both call :func:`xla_row_sum`; on the card
``csrc/xla_sum.cuh`` carries the same window split and later levels for
kernels K3 and ``row_sum``.
"""
from __future__ import annotations

import torch

#: values a window of the tree holds; rows of up to this many are summed
#: left to right from their first value
SUM_WINDOW = 32
#: first-level windows a CUDA block holds (``kMaxWindows`` in
#: ``csrc/xla_sum.cuh``), and so the longest row the kernels that sum in
#: this order (K3 and ``row_sum``) take
MAX_WINDOWS = 1024
MAX_ROW = SUM_WINDOW * MAX_WINDOWS


def window_split(n: int) -> tuple[int, int]:
    """``(windows, low padding)`` of one level over ``n`` values: ``n`` of
    at most :data:`SUM_WINDOW` values is one window with no padding."""
    if n <= SUM_WINDOW:
        return 1, 0
    windows = -(-n // SUM_WINDOW)
    return windows, (windows * SUM_WINDOW - n) // 2


def xla_row_sum(e: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (kept, as size 1) in the reference's order of
    additions: the module's rule, each addition rounded on its own."""
    while e.shape[-1] > SUM_WINDOW:
        n = e.shape[-1]
        windows, lo = window_split(n)
        pad = windows * SUM_WINDOW - n
        e = torch.nn.functional.pad(e, (lo, pad - lo))
        e = e.reshape(*e.shape[:-1], windows, SUM_WINDOW)
        acc = torch.zeros(e.shape[:-1], dtype=torch.float32, device=e.device)
        for i in range(SUM_WINDOW):
            acc = acc + e[..., i]
        e = acc
    s = e[..., 0:1]
    for j in range(1, e.shape[-1]):
        s = s + e[..., j : j + 1]
    return s
