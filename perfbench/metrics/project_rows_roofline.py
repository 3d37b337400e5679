"""The float layers' row product (``kernels/frontend.py`` ``project_rows`` ->
``csrc/frontend_rows.cu``): bf16 and fp32 convs (as their im2col rows) and
dense layers, their share of the roofline at the FP32 pipe's peak, in percent."""
from perfbench.metrics._roofline import share

KERNELS = ("project_rows_kernel",)


def read(run):
    return share(run, "project_rows", KERNELS)
