"""End to end: the 95th percentile over every decode step of the window of
the time from its issue to all its tokens on the host, the gap between
tokens each session sees (host clock)."""
import numpy as np


def read(run):
    return float(np.percentile(run.window.latencies_s, 95)) * 1e3
