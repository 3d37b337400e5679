"""The LM decode on the device: the union of the intervals in which an
operation other than the harness's logits copy ran on the card, over the
traced steps (CUPTI)."""
from perfbench.metrics import _decode


def read(run):
    seconds = _decode.device_seconds(run)
    return None if seconds is None else seconds / run.trace.blocks * 1e3
