"""Host dispatch (``serving/accelerator.py``): host time the harness's spans
around each ``accelerator_forward`` call of the measured window take to
issue a block's operations, averaged over its blocks."""


def read(run):
    spans = run.window.enqueue_s
    return sum(spans) / len(spans) * 1e3 if spans else None
