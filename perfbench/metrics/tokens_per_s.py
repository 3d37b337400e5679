"""End to end: tokens served in the measured window (slots times the decode
steps completed) over its seconds (host clock)."""


def read(run):
    return run.window.steps * run.window.slots / run.window.seconds
