"""End to end: windows scored in the measured window over its seconds (host clock)."""


def read(run):
    return run.window.rows / run.window.seconds
