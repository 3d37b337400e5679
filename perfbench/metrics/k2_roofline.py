"""Kernel K2 (``kernels/conv1d_fused.py`` -> ``csrc/conv1d_fused.cu``): the
8-bit convs' share of their roofline, in percent."""
from perfbench.metrics._roofline import share

#: K2's kernels: the tensor-core path and the Cin < 4 path
KERNELS = ("conv1d_mma_kernel", "conv1d_small_cin_kernel")


def read(run):
    return share(run, "K2", KERNELS)
