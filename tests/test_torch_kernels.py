"""Port kernels K1-K3b against the JAX Pallas kernels, bitwise.

On the CPU every port kernel wrapper runs its plain PyTorch version; each
is held bitwise against the reference kernel (Pallas, interpret mode) on
the int32 accumulators and on the fp32 outputs, over ragged shapes, K in
{1, 3, 5}, Cin = 1, per-tensor and per-sample scales, with and without
bias, ReLU and clip; the CORDIC unit in all seven modes, at its edge
values, and behind the im2col sign-off conv layer.
``test_torch_kernels_gpu.py`` holds the CUDA kernels against these plain
versions on the card.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import cordic_act as jcordic  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.conv1d_fused import conv1d_fused_q as j_conv  # noqa: E402
from repro.kernels.quant_matmul import quant_matmul as j_qmm  # noqa: E402
from repro_torch.kernels import cordic_act as tcordic  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import conv1d_fused as tconv  # noqa: E402
from repro_torch.kernels import quant_matmul as tqmm  # noqa: E402
from repro_torch.kernels.conv1d_fused import (  # noqa: E402
    conv1d_fused_q,
)
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: E402

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# K1: W8A8 matmul
# ---------------------------------------------------------------------------

QMM_SHAPES = [  # M, K, N, per-row x scale
    (1, 1, 1, False),
    (3, 37, 5, True),
    (8, 200, 64, True),
    (5, 513, 7, False),
    (16, 64, 2, True),
]
#: (bias, act, clip) epilogue variants swept on every shape
EPILOGUES = [(False, None, None), (True, None, None), (True, "relu", None),
             (False, "relu", 20.0), (True, "relu", 20.0)]


@pytest.mark.parametrize("m,k,n,per_row", QMM_SHAPES)
def test_quant_matmul_bitwise_vs_pallas(m, k, n, per_row):
    rng = np.random.default_rng(m * 1000 + k + n)
    x = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w = rng.integers(-128, 128, (k, n), dtype=np.int8)
    xs = rng.uniform(1e-3, 1e-1, (m if per_row else 1, 1)).astype(np.float32)
    ws = rng.uniform(1e-3, 1e-1, (1, n)).astype(np.float32)
    b = (rng.standard_normal(n) * 50).astype(np.float32)
    acc_j = j_qmm(*_j(x, w, xs, ws), return_acc=True, interpret=True)
    acc_t = quant_matmul(*_t(x, w, xs, ws), return_acc=True)
    assert acc_t.dtype == torch.int32
    assert _bits_equal(acc_j, acc_t.numpy())
    for has_bias, act, clip in EPILOGUES:
        bias = b if has_bias else None
        got = quant_matmul(*_t(x, w, xs, ws, bias), act=act, clip=clip)
        want = j_qmm(
            *_j(x, w, xs, ws, bias), act=act,
            clip=None if clip is None else jnp.float32(clip), interpret=True,
        )
        assert _bits_equal(want, got.numpy()), (has_bias, act, clip)


def test_quant_matmul_f32_bitwise_vs_reference():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 45)) * 3).astype(np.float32)
    w = rng.standard_normal((45, 9)).astype(np.float32)
    b = rng.standard_normal(9).astype(np.float32)
    for fxp in (False, True):
        got = tops.quant_matmul_f32(*_t(x, w, b), fxp=fxp, act="relu", clip=4.0)
        want = jops.quant_matmul_f32(*_j(x, w, b), fxp=fxp, act="relu",
                                     clip=jnp.float32(4.0), interpret=True)
        assert _bits_equal(want, got.numpy())


def test_quant_matmul_validates_arguments():
    x = torch.zeros((2, 3), dtype=torch.int8)
    w = torch.zeros((4, 5), dtype=torch.int8)
    one = torch.ones((1, 1))
    with pytest.raises(ValueError, match="expected"):
        quant_matmul(x, w, one, one)
    with pytest.raises(TypeError, match="int8"):
        quant_matmul(x.float(), w[:3], one, one)
    with pytest.raises(ValueError, match="act"):
        quant_matmul(x, w[:3], one, one, act="gelu")


# ---------------------------------------------------------------------------
# K2: fused conv
# ---------------------------------------------------------------------------

CONV_SHAPES = [  # B, L, Cin, Cout, K, per-sample x scale
    (2, 33, 1, 8, 3, True),
    (3, 50, 4, 8, 3, False),
    (2, 40, 8, 5, 1, True),
    (1, 17, 3, 4, 5, False),
    (2, 70, 6, 9, 3, True),
]


@pytest.mark.parametrize("b,l,cin,cout,k,per_sample", CONV_SHAPES)
def test_conv1d_fused_bitwise_vs_pallas(b, l, cin, cout, k, per_sample):
    rng = np.random.default_rng(b * 97 + l * 7 + cin + cout + k)
    x = rng.integers(-128, 128, (b, l, cin), dtype=np.int8)
    w = rng.integers(-128, 128, (k, cin, cout), dtype=np.int8)
    xs = (rng.uniform(1e-3, 1e-1, (b, 1)) if per_sample else np.float32(0.02)).astype(np.float32)
    ws = rng.uniform(1e-3, 1e-1, (cout,)).astype(np.float32)
    bias = (rng.standard_normal(cout) * 20).astype(np.float32)
    xs_t = torch.from_numpy(np.asarray(xs))
    acc_j = j_conv(*_j(x, w, xs, ws), return_acc=True, interpret=True)
    acc_t = conv1d_fused_q(*_t(x, w), xs_t, *_t(ws), return_acc=True)
    assert _bits_equal(acc_j, acc_t.numpy())
    for has_bias, act, clip in EPILOGUES[1:]:
        bv = bias if has_bias else None
        got = conv1d_fused_q(*_t(x, w), xs_t, *_t(ws, bv), act=act, clip=clip)
        want = j_conv(
            *_j(x, w, xs, ws, bv), act=act,
            clip=None if clip is None else jnp.float32(clip), interpret=True,
        )
        assert _bits_equal(want, got.numpy()), (has_bias, act, clip)


def test_fused_conv_matches_im2col_conv_and_reference():
    """The port's fused conv equals its im2col sign-off path on int8 payloads
    (fp32 out, no bias), and both equal the reference's."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 29, 5)) * 2).astype(np.float32)
    w = rng.standard_normal((3, 5, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    for fxp in (False, True):
        fused = tops.conv1d_fused(*_t(x, w), fxp=fxp)
        im2col = tops.conv1d_q(*_t(x, w), fxp=fxp)
        assert _bits_equal(fused.numpy(), im2col.numpy())
        assert _bits_equal(
            jops.conv1d_fused(*_j(x, w, b), fxp=fxp, act="relu", interpret=True),
            tops.conv1d_fused(*_t(x, w, b), fxp=fxp, act="relu").numpy(),
        )
        assert _bits_equal(
            jops.conv1d_q(*_j(x, w, b), fxp=fxp, interpret=True),
            tops.conv1d_q(*_t(x, w, b), fxp=fxp).numpy(),
        )


def test_conv1d_validates_arguments():
    x = torch.zeros((2, 8, 3), dtype=torch.int8)
    w = torch.zeros((3, 4, 5), dtype=torch.int8)
    with pytest.raises(ValueError, match="expected"):
        conv1d_fused_q(x, w, torch.ones(1), torch.ones(5))
    with pytest.raises(ValueError, match="x_scale"):
        conv1d_fused_q(x, w[:, :3], torch.ones(3), torch.ones(5))


#: (B, L, Cin, Cout, K): the serving convs at 8 slots (conv0-2, pruned
#: conv2), then the edge shapes the card tests cover
CONV_TILING_SHAPES = [
    (8, 1096, 1, 64, 3), (8, 548, 64, 128, 3), (8, 274, 128, 256, 3), (8, 274, 128, 64, 3),
    (2, 1, 4, 8, 1), (2, 63, 5, 70, 5), (3, 77, 12, 20, 1), (2, 100, 200, 33, 3),
    (1, 1096, 33, 7, 5), (2, 30, 200, 70, 7), (1, 40, 1024, 1024, tconv.MAX_TAPS),
]


@pytest.mark.parametrize("b,l,cin,cout,k", CONV_TILING_SHAPES)
def test_conv_tiling_fits_shared_memory(b, l, cin, cout, k):
    """Every shape gets a tile under the block's 227 KB of shared memory, with
    the kernel's own stage formula; the serving convs fill the 132 SMs."""
    t = tconv.conv_tiling(b, l, cin, cout, k)
    assert t.smem_bytes <= tconv.SMEM_LIMIT == 232_448
    if cin < 4:
        assert (t.bm, t.bn, t.stages, t.smem_bytes) == (0, 0, 0, 0)
        assert t.blocks == -(-b * l * -(-cout // 4) // 256)
    else:
        assert (t.bm, t.bn) in tconv.TILES and t.stages in (2, 3, 4)
        assert t.smem_bytes == t.stages * (t.bm + k - 1 + k * t.bn) * tconv.STAGE_ROW_BYTES
        assert t.blocks == b * -(-l // t.bm) * -(-cout // t.bn)
    if b == 8:
        assert t.blocks >= tconv.SMS


def test_conv_tiling_constants_match_the_cuda_source():
    src = (CSRC / "conv1d_fused.cu").read_text()
    cc = int(re.search(r"constexpr int kCC = (\d+);", src).group(1))
    assert cc == tconv.STAGE_CHANNELS
    assert "constexpr int kStride = kCC + 16;" in src and cc + 16 == tconv.STAGE_ROW_BYTES
    assert '#include "imma.cuh"' in src
    assert '#include "imma.cuh"' in (CSRC / "quant_matmul.cu").read_text()
    qsrc = (CSRC / "quant_matmul.cu").read_text()
    assert int(re.search(r"constexpr int kKC = (\d+);", qsrc).group(1)) == tqmm.CHUNK_K
    assert int(re.search(r"constexpr int kBN = (\d+);", qsrc).group(1)) == tqmm.BLOCK_N


def test_packed_weight_is_k_major_and_cached():
    """The tensor-core layout (K, Cout, Cin) read back by index is ``w_q``;
    it is packed once per weight tensor and again after an in-place write."""
    rng = np.random.default_rng(23)
    w = torch.from_numpy(rng.integers(-128, 128, (3, 33, 70), dtype=np.int8))
    wp = tconv.packed_weight(w)
    assert wp.shape == (3, 70, 33) and wp.is_contiguous()
    for t, c, o in ((0, 0, 0), (2, 32, 69), (1, 17, 5), (2, 0, 69)):
        assert wp[t, o, c] == w[t, c, o]
    assert torch.equal(wp.permute(0, 2, 1), w)
    assert tconv.packed_weight(w) is wp
    w[1, 17, 5] = -w[1, 17, 5] - 1
    again = tconv.packed_weight(w)
    assert again is not wp and again[1, 5, 17] == w[1, 17, 5]
    view = w[:, :, ::2]
    assert torch.equal(tconv.packed_weight(view).permute(0, 2, 1), view)
    with torch.inference_mode():
        frozen = torch.zeros((1, 4, 8), dtype=torch.int8)
    assert torch.equal(tconv.packed_weight(frozen), frozen.permute(0, 2, 1))


@pytest.mark.parametrize("m,k,n,bm,splits", [
    (8, 35072, 64, 8, 137),     # dense0
    (8, 8704, 64, 8, 34),       # dense0, pruned
    (8, 64, 2, 8, 1),           # dense1
    (64, 8704, 64, 64, 34),
    (9, 37, 5, 64, 1),
    (1, 1, 1, 8, 1),
    (8768, 3, 64, 64, 1),       # the im2col sign-off layers
    (4384, 192, 128, 64, 1),
    (2192, 384, 256, 64, 1),
    (1, 0, 4, 8, 1),
])
def test_qmm_tiling_splits_k_only_to_fill_the_card(m, k, n, bm, splits):
    t = tqmm.qmm_tiling(m, k, n)
    assert (t.bm, t.splits) == (bm, splits)
    assert t.m_tiles * t.bm >= m and t.n_tiles * tqmm.BLOCK_N >= n
    span = t.chunks_per_block * tqmm.CHUNK_K
    assert t.splits * span >= k and (t.splits - 1) * span < max(k, 1)  # no empty split
    if t.m_tiles * t.n_tiles < tqmm.SMS and k >= tqmm.SMS * tqmm.CHUNK_K:
        assert t.blocks >= tqmm.SMS


# ---------------------------------------------------------------------------
# K3: CORDIC
# ---------------------------------------------------------------------------


def _act_inputs():
    rng = np.random.default_rng(17)
    return np.concatenate([
        rng.uniform(-40, 40, 3000), rng.uniform(-3, 3, 3000),
        rng.standard_normal(2000) * 8, [0.0, -0.0, 4.4, -4.4, 30.0, -30.0, 1e-30],
    ]).astype(np.float32)


@pytest.mark.parametrize("mode", tcordic.MODES)
def test_cordic_activation_all_modes_bitwise(mode):
    x = _act_inputs()
    want = jcordic.cordic_activation(jnp.asarray(x), mode, interpret=True)
    got = tcordic.cordic_activation(torch.from_numpy(x), mode)
    assert _bits_equal(want, got.numpy())


def test_cordic_sinh_cosh_every_angle_vs_reference():
    """The port's Q15.16 CORDIC equals the reference's for every angle the
    unit can see, |z| <= Z_MAX (tanh's clamp at 4.4, over 4)."""
    z = np.arange(-tcordic.Z_MAX, tcordic.Z_MAX + 1, dtype=np.int32)
    want_c, want_s = jcordic._cordic_sinh_cosh(jnp.asarray(z))
    got_c, got_s = tcordic.cordic_sinh_cosh(torch.from_numpy(z))
    assert _bits_equal(want_c, got_c.numpy()) and _bits_equal(want_s, got_s.numpy())


def test_cordic_intermediates_exact_in_fp32():
    """What lets the kernels run the stages on the FP32 pipe (cordic.cuh):
    over every angle the unit can see, every intermediate of the x, y and z
    chains is an integer below 2^17 (fp32 holds integers below 2^24, and the
    rounding-down FMA floors exactly below 2^22)."""
    z = torch.arange(-tcordic.Z_MAX, tcordic.Z_MAX + 1, dtype=torch.int32)
    x, y = torch.full_like(z, tcordic.X0), torch.zeros_like(z)
    peak = 0
    for shift, e in zip(tcordic.ITERS, tcordic.ATANH_TABLE):
        d_pos = z >= 0
        xs, ys = x >> shift, y >> shift
        x, y, z = (torch.where(d_pos, x + ys, x - ys), torch.where(d_pos, y + xs, y - xs),
                   torch.where(d_pos, z - e, z + e))
        peak = max(peak, int(x.abs().max()), int(y.abs().max()), int(z.abs().max()))
    assert peak < 2**17


@pytest.mark.parametrize("mode", tcordic.MODES)
def test_cordic_activation_every_angle_bitwise(mode):
    """``apply_mode`` against the Pallas kernel on inputs that reach every
    Q15.16 angle the mode can feed the CORDIC (``angle_grid``)."""
    x = tcordic.angle_grid(mode)
    want = jcordic.cordic_activation(jnp.asarray(x.numpy()), mode, interpret=True)
    got = tcordic.cordic_activation(x, mode)
    assert _bits_equal(want, got.numpy())


@pytest.mark.parametrize("cols", [1, 2, 3, 5, 17, 32, 33, 100, 1025, 1100, 4096])
def test_cordic_softmax_bitwise(cols):
    rng = np.random.default_rng(cols)
    x = (rng.standard_normal((24, cols)) * 10.0 ** rng.uniform(-1, 2, (24, 1))).astype(np.float32)
    x[0, :] = 0.0
    x[1, 0] = 200.0  # exp arguments hit the -30 clip
    want = jcordic.cordic_softmax(jnp.asarray(x), interpret=True)
    got = tcordic.cordic_softmax(torch.from_numpy(x))
    assert _bits_equal(want, got.numpy())
    # the wrapper's plain path is the step-for-step twin of the kernel
    assert _bits_equal(got.numpy(), tcordic.cordic_softmax_plain(torch.from_numpy(x)).numpy())


def test_cordic_softmax_other_axis():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4, 2)).astype(np.float32)
    want = jcordic.cordic_softmax(jnp.asarray(x), axis=1, interpret=True)
    got = tcordic.cordic_softmax(torch.from_numpy(x), axis=1)
    assert _bits_equal(want, got.numpy())


#: the edges of the CORDIC unit: the tanh saturation at +-4.4 and the value
#: just inside it, beyond the +-30 clip of the exp argument, signed zeros,
#: tiny and huge magnitudes
EDGES = np.array([
    4.4, -4.4, np.nextafter(np.float32(4.4), 0), -np.nextafter(np.float32(4.4), 0),
    30.0, -30.0, 30.5, -30.5, 80.0, -80.0, -0.0, 0.0, 1e-30, -1e-30, 1e4, -1e4,
    2.2, -2.2, 8.8, -8.8,
], np.float32)


@pytest.mark.parametrize("mode", tcordic.MODES)
def test_cordic_activation_edge_values_bitwise(mode):
    want = jcordic.cordic_activation(jnp.asarray(EDGES), mode, interpret=True)
    got = tcordic.cordic_activation(torch.from_numpy(EDGES), mode)
    assert _bits_equal(want, got.numpy())


def test_cordic_activation_any_shape():
    """Any shape and dtype in, fp32 of the same shape out; empty is empty."""
    x = np.random.default_rng(4).uniform(-6, 6, (3, 5, 7)).astype(np.float32)
    want = jcordic.cordic_activation(jnp.asarray(x), "gelu", interpret=True)
    got = tcordic.cordic_activation(torch.from_numpy(x.astype(np.float64)), "gelu")
    assert got.dtype == torch.float32 and _bits_equal(want, got.numpy())
    assert tcordic.cordic_activation(torch.zeros((0, 4)), "selu").shape == (0, 4)
    relu = tcordic.cordic_activation(torch.tensor([float("nan"), -0.0, -1.0, 2.0]), "relu")
    assert torch.isnan(relu[0]) and relu[1:].tolist() == [0.0, 0.0, 2.0]
    assert not np.signbit(relu[1].numpy())
    with pytest.raises(ValueError, match="unknown CORDIC mode"):
        tcordic.cordic_activation(torch.zeros(2), "softplus")


@pytest.mark.parametrize("fxp", [False, True])
def test_im2col_signoff_layer_bitwise_vs_reference(fxp):
    """``cordic_activation(conv1d_q(x, w, b), "relu")``, the layer the fused
    conv is signed off against, at a narrow width of each canonical conv."""
    rng = np.random.default_rng(12)
    for cin, cout in ((1, 8), (8, 16)):
        x = (rng.standard_normal((2, 37, cin)) * 3).astype(np.float32)
        w = (rng.standard_normal((3, cin, cout)) * 0.3).astype(np.float32)
        b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
        want = jcordic.cordic_activation(jops.conv1d_q(*_j(x, w, b), fxp=fxp, interpret=True),
                                         "relu", interpret=True)
        got = tcordic.cordic_activation(tops.conv1d_q(*_t(x, w, b), fxp=fxp), "relu")
        assert _bits_equal(want, got.numpy())


def test_cuda_source_constants_match_python():
    """The CUDA CORDIC (``cordic.cuh``, shared by K3 and K3b) hard-codes the
    iteration schedule, the atanh table and the pre-scaled start value;
    they must equal the Python ones, and both kernels must include it."""
    src = (CSRC / "cordic.cuh").read_text()
    for kernel in ("cordic_softmax.cu", "cordic_act.cu"):
        assert '#include "cordic.cuh"' in (CSRC / kernel).read_text()

    def table(name):
        body = re.search(name + r"\[20\] = \{([^}]*)\}", src).group(1)
        return tuple(int(v) for v in body.replace("\n", " ").split(",") if v.strip())

    assert table("kIters") == tcordic.ITERS
    assert table("kAtanh") == tcordic.ATANH_TABLE
    assert int(re.search(r"kX0 = (\d+);", src).group(1)) == tcordic.X0


# ---------------------------------------------------------------------------
# the float oracles of kernels/ref.py (the reference's tolerance budget)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", tcordic.MODES)
def test_cordic_modes_close_to_float_refs(mode):
    x = torch.from_numpy(np.random.default_rng(5).uniform(-6, 6, (7, 129)).astype(np.float32))
    y = tcordic.cordic_activation(x, mode)
    want = tref.ACT_REFS[mode](x)
    if mode == "exp":
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=3e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(y.numpy(), want.numpy(), atol=2e-3)
    sm = tcordic.cordic_softmax(x)
    np.testing.assert_allclose(sm.sum(-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(sm.numpy(), tref.softmax_ref(x).numpy(), atol=1e-4)


def test_quantised_paths_within_budget_of_float_refs():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 64, 8)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 8, 16)) * 0.2).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    want = tref.conv1d_q_ref(x, w, b)
    np.testing.assert_allclose(  # the float oracle itself agrees with the reference's
        want.numpy(), np.asarray(jref.conv1d_q_ref(*_j(x.numpy(), w.numpy(), b.numpy()))),
        rtol=1e-5, atol=1e-5,
    )
    for got in (tops.conv1d_q(x, w, b), tops.conv1d_fused(x, w, b)):
        assert float((got - want).norm() / want.norm()) < 0.03
    xq = torch.randint(-128, 128, (5, 40), dtype=torch.int8)
    wq = torch.randint(-128, 128, (40, 6), dtype=torch.int8)
    xs, ws = torch.full((5, 1), 0.01), torch.full((1, 6), 0.02)
    np.testing.assert_allclose(quant_matmul(xq, wq, xs, ws).numpy(),
                               tref.quant_matmul_ref(xq, wq, xs, ws).numpy(), rtol=1e-6, atol=1e-5)
