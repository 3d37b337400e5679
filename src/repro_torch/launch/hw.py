"""The H100's peak rates and sizes, in one place.

Counterpart of ``benchmarks/hw.py`` (the TPU v5e's constants there do not
apply to the port).  Every bound the port states (``chip_smoke.py``'s
kernel bounds, ``launch/roofline.py``'s terms) is computed from these.
All values are NVIDIA's datasheet figures for the H100 SXM5 80 GB at its
700 W limit; a card set to a lower power limit runs slower under load.
"""
from __future__ import annotations

#: H100 SXM5 80 GB: dense int8 tensor-core peak, OP/s
INT8_OPS_PER_S = 1.979e15
#: H100 SXM5 80 GB: dense bf16 tensor-core peak, FLOP/s
BF16_FLOPS_PER_S = 989e12
#: H100 SXM5 80 GB: fp32 outside the tensor cores, FLOP/s
FP32_FLOPS_PER_S = 67e12
#: H100 SXM5 80 GB: HBM3 bandwidth, B/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM5 80 GB: HBM capacity, bytes, the datasheet's 80 GB (the dry
#: run's ``fits_80gb``; ``chip_smoke.py`` phase 11 prints the total memory
#: the card reports)
HBM_BYTES = 80e9
#: H100 SXM5 80 GB: NVLink 4, 18 links, bytes a second in one direction
NVLINK_BYTES_PER_S = 450e9
