"""Kernel K1 (``kernels/quant_matmul.py`` -> ``csrc/quant_matmul.cu``): the
8-bit dense layers' share of their roofline, in percent."""
from perfbench.metrics._roofline import share

KERNELS = ("qmm_kernel",)


def read(run):
    return share(run, "K1", KERNELS)
