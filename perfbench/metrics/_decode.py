"""Shared arithmetic of the LM decode's device readings."""
from perfbench import tracing


def device_seconds(run):
    """Seconds of the traced segment in which an operation other than the
    harness's logits copy (``tracing.HARNESS_COPIES``) ran on the card:
    the union of their intervals; nothing where the trace holds none."""
    if run.trace is None:
        return None
    ops = [(op.start_ns, op.start_ns + op.dur_ns) for op in run.trace.device_ops
           if not op.name.startswith(tracing.HARNESS_COPIES)]
    if not ops:
        return None
    return sum(e - s for s, e in tracing._union(ops)) / 1e9
