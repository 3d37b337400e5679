"""The datapath on the device (``forward_quantized``): device time of every
operation of the traced segment but the harness's own staging and result
copies, over its blocks (CUPTI)."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    return run.trace.datapath_seconds() / run.trace.blocks * 1e3
