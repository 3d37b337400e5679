"""The device, under LM decode: the share of the traced steps in which no
operation ran on the card (one minus the union of its activity intervals
over the segment's length, CUPTI), in percent."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
