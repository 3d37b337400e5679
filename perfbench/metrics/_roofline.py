"""Shared arithmetic of the kernels' roofline shares: the traced forwards'
least time on the layers a kernel runs (``yardstick``'s bounds) over the
device time of that kernel's launches (CUPTI), in percent; nothing where
no layer runs on the kernel or the trace holds none of its launches."""


def share(run, kernel: str, names: tuple[str, ...]):
    if run.trace is None:
        return None
    bound = sum(layer.bound_s_per_call for layer in run.layers if layer.kernel == kernel)
    seconds, launches = run.trace.kernel_seconds(*names)
    if bound == 0 or launches == 0:
        return None
    return 100.0 * bound * run.trace.blocks / seconds
