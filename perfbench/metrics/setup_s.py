"""End to end: process start to the first timed block, the synthesis of the
bank, the bake, the kernels' build and load and the warm-up blocks included."""


def read(run):
    return run.setup_s
