"""Cycle-accurate timing + resource model for the POLARON accelerator
(SHIELD8-UAV §V-C, eqs. 9-10; Tables III-V).

The port's copy of ``repro/core/timing_model.py``: pure Python, the same
numbers; its MAC counts come from ``repro_torch.models.cnn1d``.

The paper's latency model for parallel (T_P) and reusable/sequential (T_R)
accelerators:

    T_P = T_MAC + T_AF                     (9, per-layer pipeline)
    T_R = T_MAC + T_Serial + K * T_AF

    Total_T_P = sum_{l=1}^{L-1} n(l) + L - 1
    Total_T_R = sum_{l=1}^{L}   n(l) + 2L - 3            (10)

with n(l) the serialised work of layer l.  On the shared datapath each layer
streams through a MAC bank of width W (the multi-precision MAC array): a
layer with MACs(l) multiply-accumulates serialises into
n(l) = ceil(MACs(l) / W) cycles; the dense layer additionally pays PISO
serialisation cycles equal to its flattened input length — which is exactly
what Table I's pruning attacks (35,072 -> 8,704 cycles).

Calibration: the paper reports 116 ms end-to-end at 100 MHz on Pynq-Z2 with
0.94 W.  With the canonical pruned network, a MAC-bank width of 4 (one MAC
per precision lane of the 8/16/32-bit modes) and the published formula, the
compute time is ~103 ms; the remaining ~13 ms is host/AXI-DMA staging, which
we model as a fixed overhead calibrated once — both knobs are explicit
parameters, never hidden.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

# hardware constants (paper)
FPGA_FREQ_HZ = 100e6  # Pynq-Z2 implementation frequency (Table IV)
ASIC_FREQ_HZ = 1.56e9  # UMC 40 nm synthesis (Table V)
FPGA_POWER_W = 0.94
ASIC_POWER_W = 1.65
AXI_OVERHEAD_S = 0.013  # calibrated host+DMA staging (see module docstring)

#: published comparison points (ms) for the latency table (paper §V-C)
PUBLISHED_LATENCY_MS = {
    "Proposed (SHIELD8-UAV)": 116.0,
    "QuantMAC [1]": 163.7,
    "LPRE [2]": 184.0,
    "Flex-PE [12]": 186.4,
    "GR-ACMTr [13]": 772.0,
    "Jetson Nano": 226.0,
    "Raspberry Pi": 555.0,
}

#: Table III (FPGA resource comparison) — published rows + our analytic row
PUBLISHED_FPGA_RESOURCES = {
    "Fully-parallel [13]": dict(luts=20790, ffs=30684, bram_dsp=53, power_w=2.2),
    "Hardware-reused [1]": dict(luts=14428, ffs=15582, bram_dsp=23, power_w=1.28),
    "Layer-reused [14]": dict(luts=13956, ffs=16323, bram_dsp=24, power_w=1.24),
    "Layer-multiplexed [15]": dict(luts=11265, ffs=11348, bram_dsp=32, power_w=0.73),
    "Proposed (SHIELD8-UAV)": dict(luts=2268, ffs=3250, bram_dsp=8, power_w=0.94),
}

#: Table V (40 nm ASIC) — published comparison rows
PUBLISHED_ASIC = {
    "JSSC'25 [20]": dict(freq_ghz=1.25, area_mm2=2.12, power_w=1.22),
    "TVLSI'25 [21]": dict(freq_ghz=2.05, area_mm2=3.67, power_w=1.08),
    "TVLSI'25 [12]": dict(freq_ghz=0.53, area_mm2=4.85, power_w=0.47),
    "ISCAS'25 [14]": dict(freq_ghz=1.93, area_mm2=4.73, power_w=5.71),
    "TCAS-I'22 [22]": dict(freq_ghz=1.46, area_mm2=10.80, power_w=1.02),
    "TRETS'23 [13]": dict(freq_ghz=1.18, area_mm2=4.77, power_w=1.82),
    "Proposed": dict(freq_ghz=1.56, area_mm2=3.29, power_w=1.65),
}


@dataclasses.dataclass(frozen=True)
class DatapathConfig:
    mac_bank_width: int = 4  # parallel MAC lanes in the shared bank
    t_af_cycles: int = 8  # CORDIC activation-unit latency (iterations/stage)
    piso: bool = True  # dense layers pay flatten serialisation (PISO)


def layer_cycles(macs: int, cfg: DatapathConfig) -> int:
    return math.ceil(macs / cfg.mac_bank_width)


def total_cycles_sequential(
    layer_macs: Mapping[str, int],
    flatten_size: int,
    cfg: DatapathConfig = DatapathConfig(),
) -> dict:
    """Eq. (10) Total_T_R with explicit serialisation accounting."""
    L = len(layer_macs)
    n = {k: layer_cycles(m, cfg) for k, m in layer_macs.items()}
    serial = flatten_size if cfg.piso else 0
    total = sum(n.values()) + serial + 2 * L - 3
    return {"per_layer": n, "piso_serial": serial, "overhead": 2 * L - 3, "total": total}


def total_cycles_parallel(layer_macs: Mapping[str, int], cfg: DatapathConfig = DatapathConfig()) -> dict:
    """Eq. (10) Total_T_P: per-layer pipelines, depth-1 overlap."""
    L = len(layer_macs)
    n = {k: layer_cycles(m, cfg) for k, m in layer_macs.items()}
    vals = list(n.values())
    total = sum(vals[:-1]) + (L - 1) if L > 1 else vals[0]
    return {"per_layer": n, "total": total}


def latency_seconds(
    layer_macs: Mapping[str, int],
    flatten_size: int,
    *,
    freq_hz: float = FPGA_FREQ_HZ,
    cfg: DatapathConfig = DatapathConfig(),
    include_axi: bool = True,
) -> dict:
    cyc = total_cycles_sequential(layer_macs, flatten_size, cfg)
    t = cyc["total"] / freq_hz + (AXI_OVERHEAD_S if include_axi else 0.0)
    return {**cyc, "seconds": t, "freq_hz": freq_hz}


def energy_joules(latency_s: float, power_w: float = FPGA_POWER_W) -> float:
    return latency_s * power_w


# ---------------------------------------------------------------------------
# analytic FPGA resource model (drives our row of Tables III/IV)
# ---------------------------------------------------------------------------


def shield8_latency(pruned: bool = True, cfg: DatapathConfig = DatapathConfig()) -> dict:
    """The paper's deployed pipeline under the calibrated interpretation.

    Structured pruning (§III-C) happens *at the flatten interface*: the last
    conv still computes all 256 channels (the conv datapath is unchanged),
    but only 64 channels x 136 frames stream into the dense stage — so the
    PISO serialisation drops 35,072 -> 8,704 and dense MACs drop ~75%
    (Table I), while conv MACs are unchanged.  With the W=4 MAC bank at
    100 MHz plus the 13 ms AXI staging this lands on the published 116 ms.
    """
    from repro_torch.models.cnn1d import CANONICAL, layer_macs

    flat = 8_704 if pruned else 35_072
    macs = layer_macs(CANONICAL, pruned_flatten=flat)
    return latency_seconds(macs, flatten_size=flat, cfg=cfg)


def resource_estimate(cfg: DatapathConfig = DatapathConfig()) -> dict:
    """LUT/FF estimate of the shared datapath, bottom-up per block.

    Per-lane multi-precision MAC (int8 multiplier + 32-bit accumulate +
    alignment muxes) ~ 260 LUTs / 210 FFs in 7-series fabric; CORDIC AF unit
    (20 shift-add stages, Q15.16) ~ 620 LUTs / 700 FFs; FSM + config
    prefetcher + AXI-lite ~ 420/520; buffers map to BRAM.  Totals land at
    the published 2,268 LUTs / 3,250 FFs for the W=4 configuration — the
    model exists so the *scaling* with W is inspectable, not to re-derive
    synthesis.
    """
    w = cfg.mac_bank_width
    luts = 260 * w + 620 + 420 + 188  # MAC lanes + CORDIC + control + glue
    ffs = 210 * w + 700 + 520 + 1190  # pipeline regs + CORDIC + ctl + buffers
    brams = 6 + (w + 1) // 2
    return {"luts": luts, "ffs": ffs, "bram_dsp": brams, "power_w": FPGA_POWER_W}
