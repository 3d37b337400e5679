"""The LM decode step's share of its roofline, in percent: the least time
of the traced steps (``yardstick.DecodeCost.step_bound_s`` at each step's
position: every weight byte and each slot's keys and values of its context
once, at the HBM peak) over the device time they took
(:func:`_decode.device_seconds`)."""
from perfbench.metrics import _decode


def read(run):
    seconds = _decode.device_seconds(run)
    if seconds is None or not run.traced_positions:
        return None
    return 100.0 * sum(run.cost.step_bound_s(p) for p in run.traced_positions) / seconds
