"""The yardstick: the H100's peaks, what each layer of a forward costs, and
the least time the card could take for it.

The peaks are copied from ``src/repro_torch/launch/hw.py`` (NVIDIA's data
sheet for the H100 SXM5 80 GB, dense rates, at its 700 W power limit; a
card set to a lower limit runs slower under load, so every run prints the
card's limit beside its numbers).  ``qmm_cost``, ``conv_cost``,
``project_cost`` and ``bound_s`` are copied from ``chip_smoke.py``
(``qmm_cost``, ``conv_cost``, ``project_cost``, ``bound_ms``), taking
shapes in place of tensors: each input byte is counted once and each
output byte once, whatever a kernel reads again.
"""
from __future__ import annotations

import dataclasses

from perfbench import spec

#: dense int8 tensor-core peak, OP/s
INT8_OPS_PER_S = 1.979e15
#: dense bf16 tensor-core peak, FLOP/s
BF16_FLOPS_PER_S = 989e12
#: fp32 outside the tensor cores, FLOP/s
FP32_FLOPS_PER_S = 67e12
#: HBM3 bandwidth, B/s
HBM_BYTES_PER_S = 3.35e12

#: the peak of each precision a configuration states (``mfu``)
PEAK_OF_PRECISION = {
    "int8": INT8_OPS_PER_S,
    "fxp8": INT8_OPS_PER_S,
    "bf16": BF16_FLOPS_PER_S,
    "fp32": FP32_FLOPS_PER_S,
}
#: the peak of the arithmetic each kernel runs (its roofline): the float
#: layers' ``project_rows`` sums bf16 operands widened to fp32 on the FP32 pipe
PEAK_OF_KERNEL = {"K2": INT8_OPS_PER_S, "K1": INT8_OPS_PER_S, "project_rows": FP32_FLOPS_PER_S}


def qmm_cost(m: int, k: int, n: int) -> tuple[int, int]:
    """(bytes, int8 operations) of one K1 call, (M, K) x (K, N): the int8
    operands, the fp32 scales and bias, the fp32 output."""
    return m * k + k * n + 4 * (m + 2 * n) + 4 * m * n, 2 * m * k * n


def conv_cost(b: int, l: int, cin: int, cout: int, k: int) -> tuple[int, int]:
    """(bytes, int8 operations) of one K2 call, (B, L, Cin) x (K, Cin, Cout)."""
    return (b * l * cin + k * cin * cout + 4 * (b + 2 * cout) + 4 * b * l * cout,
            2 * b * l * k * cin * cout)


def project_cost(r: int, k: int, n: int) -> tuple[int, int]:
    """(bytes, fp32 operations) of one ``project_rows`` call, (R, K) x (K, N)."""
    return 4 * (r * k + k * n + r * n), 2 * r * k * n


def bound_s(bytes_moved: float, ops: float, peak_ops: float) -> float:
    """The least time: the larger of the bytes over HBM bandwidth and the
    operations over the peak."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / peak_ops)


@dataclasses.dataclass(frozen=True)
class Layer:
    """One layer of the forward at a block of ``rows``: the kernel it runs
    on, its operations a row, and one call's bytes, operations and bound."""

    name: str
    precision: str
    kernel: str
    ops_per_row: int
    bytes_per_call: int
    ops_per_call: int
    bound_s_per_call: float

    @property
    def ideal_s_per_row(self) -> float:
        """A row's operations at the peak of the stated precision."""
        return self.ops_per_row / PEAK_OF_PRECISION[self.precision]


def _layer(name, mode, rows, shape, kind) -> Layer:
    if kind == "conv":
        l, cin, cout, k = shape
        if mode in spec.EIGHT_BIT:
            kernel, (nbytes, ops) = "K2", conv_cost(rows, l, cin, cout, k)
        else:  # the product of the im2col rows
            kernel, (nbytes, ops) = "project_rows", project_cost(rows * l, k * cin, cout)
        per_row = 2 * l * k * cin * cout
    else:
        kin, n = shape
        if mode in spec.EIGHT_BIT:
            kernel, (nbytes, ops) = "K1", qmm_cost(rows, kin, n)
        else:
            kernel, (nbytes, ops) = "project_rows", project_cost(rows, kin, n)
        per_row = 2 * kin * n
    return Layer(name, mode, kernel, per_row, nbytes, ops,
                 bound_s(nbytes, ops, PEAK_OF_KERNEL[kernel]))


def layers(conf: dict, rows: int) -> list[Layer]:
    """The forward's layers for configuration ``conf`` at ``rows`` a call:
    the convs (the last one's output channels cut to the prune's ``keep``),
    the frame trim before the flatten, then the two dense layers."""
    cnn = conf["cnn"]
    modes = spec.layer_modes(conf)
    prune = conf.get("prune")
    out, l, cin, k = [], cnn["input_len"], 1, cnn["kernel"]
    channels = list(cnn["channels"])
    if prune:
        channels[-1] = prune["keep"]
    for i, cout in enumerate(channels):
        out.append(_layer(f"conv{i}", modes[f"conv{i}"], rows, (l, cin, cout, k), "conv"))
        l, cin = l // 2, cout
    frames = l - (prune["trim_frames"] if prune else 0)
    out.append(_layer("dense0", modes["dense0"], rows, (frames * cin, cnn["hidden"]), "dense"))
    out.append(_layer("dense1", modes["dense1"], rows, (cnn["hidden"], cnn["n_classes"]), "dense"))
    return out


@dataclasses.dataclass(frozen=True)
class DecodeCost:
    """The least work of one LM decode step of ``slots`` sessions, each at
    position ``pos`` (it writes position ``pos`` and attends to ``pos + 1``
    positions), from the weights the configuration serves and the
    reference's :func:`cost_terms`: every weight byte read once, each slot's
    keys and values of the positions it attends to read or written once,
    its recurrent state read and written once, the logits written once in
    float32; FLOPs twice the parameters a token (the tied table once, as
    the unembed's product) and the attention's over the positions."""

    slots: int
    params: int
    weight_bytes: int
    vocab: int
    kv_bytes_per_position: int
    state_bytes_per_slot: int
    attn_flops_per_position: int

    def step_bytes(self, pos: int) -> int:
        per_slot = self.kv_bytes_per_position * (pos + 1) + 2 * self.state_bytes_per_slot
        return self.weight_bytes + self.slots * (per_slot + 4 * self.vocab)

    def token_flops(self, pos: int) -> int:
        return 2 * self.params + self.attn_flops_per_position * (pos + 1)

    def step_bound_s(self, pos: int) -> float:
        """The least time of a step at the HBM and bf16 peaks."""
        return bound_s(self.step_bytes(pos), self.slots * self.token_flops(pos),
                       BF16_FLOPS_PER_S)


def decode_cost(leaves: dict, terms: dict, slots: int, vocab: int) -> DecodeCost:
    """A :class:`DecodeCost` from the weights' leaves (path -> tensor, as
    served: their element counts and sizes) and a reference's cost terms."""
    return DecodeCost(slots=slots, params=sum(w.numel() for w in leaves.values()),
                      weight_bytes=sum(w.numel() * w.element_size() for w in leaves.values()),
                      vocab=vocab, **terms)
