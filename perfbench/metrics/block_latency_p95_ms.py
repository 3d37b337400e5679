"""End to end: the 95th percentile over every block of the window of the
time from its staging to its probabilities on the host (host clock)."""
import numpy as np


def read(run):
    return float(np.percentile(run.window.latencies_s, 95)) * 1e3
