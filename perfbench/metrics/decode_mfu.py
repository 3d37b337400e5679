"""The whole decode step: the measured window's tokens a second times a
token's FLOPs (twice the parameters, and the attention's over the context
at each step's position, averaged over the window's steps) at the card's
dense bf16 peak, in percent."""
from perfbench import yardstick


def read(run):
    w = run.window
    if not w.steps:
        return None
    flops = sum(run.cost.token_flops(p) for p in w.positions) / w.steps
    return 100.0 * w.steps * w.slots / w.seconds * flops / yardstick.BF16_FLOPS_PER_S
