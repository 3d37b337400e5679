"""The detector's program: the port's ``accelerator_forward`` scoring
blocks of windows in a closed loop (``harness.run_cell``, the harness's
own module, which holds it unchanged)."""
from perfbench import harness


def run_cell(cell, seed: int, seconds: float, trace: bool, *, t_start=None) -> dict:
    """One run of a detector cell: the result line's object."""
    return harness.run_cell(cell, seed, seconds, trace, t_start=t_start)
