"""The CUDA kernels against their plain PyTorch versions, on the card: K1-K3
(K1 and K2 on outputs and accumulators over ragged M, Cin, L and K, with
per-tensor and per-sample scales and clip, and K1's split-K workspace left
clean),
K3b in all seven modes (on every angle the unit can see, at ragged sizes
and on views at odd offsets), the front-end's fixed-order primitives (the
projection also at the float layers' shapes, and at ragged shapes with
every tile, its k split over chunks and not), the row independence of the
on-device front-end and of a float dense layer at the canonical width, and
the sharded forward over entries of one card.

Marked ``gpu``: every test skips without a CUDA device (the kernels have no
CPU mode).  The file imports neither JAX nor ``repro``, so it runs on a GPU
host that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

The plain versions are themselves held bitwise against the JAX reference
by ``test_torch_kernels.py`` on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import features_torch  # noqa: E402
from repro_torch.data.features import FEATURE_DIMS, N_SAMPLES  # noqa: E402
from repro_torch.kernels import cordic_act as tcordic  # noqa: E402
from repro_torch.kernels import frontend  # noqa: E402
from repro_torch.kernels import quant_matmul as tqmm  # noqa: E402
from repro_torch.kernels.conv1d_fused import conv1d_fused_q, conv1d_fused_q_plain  # noqa: E402
from repro_torch.kernels.quant_matmul import quant_matmul, quant_matmul_plain  # noqa: E402

torch.set_num_threads(1)

QMM_SHAPES = [(1, 1, 1), (3, 37, 5), (8, 200, 64), (5, 513, 7), (16, 64, 2),
              (8, 35072, 64), (3, 8703, 5)]
CONV_SHAPES = [  # B, L, Cin, Cout, K
    (2, 33, 1, 8, 3), (3, 50, 4, 8, 3), (2, 40, 8, 5, 1), (1, 17, 3, 4, 5),
    (2, 70, 6, 9, 3), (8, 1096, 1, 64, 3), (8, 274, 128, 256, 3), (2, 30, 200, 70, 7),
]


def _bits_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b,
    )


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", QMM_SHAPES)
def test_quant_matmul_kernel_vs_plain_on_card(card, m, k, n):
    rng = np.random.default_rng(k)
    x, w = (torch.from_numpy(rng.integers(-128, 128, s, dtype=np.int8)).to(card)
            for s in ((m, k), (k, n)))
    xs = torch.from_numpy(rng.uniform(1e-3, 1e-1, (m, 1)).astype(np.float32)).to(card)
    ws = torch.from_numpy(rng.uniform(1e-3, 1e-1, (1, n)).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(card)
    assert _bits_equal(quant_matmul(x, w, xs, ws, return_acc=True),
                       quant_matmul_plain(x, w, xs, ws, return_acc=True))
    got = quant_matmul(x, w, xs, ws, b, act="relu", clip=3.0)
    torch.cuda.synchronize()
    assert _bits_equal(got, quant_matmul_plain(x, w, xs, ws, b, act="relu", clip=3.0))


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,cin,cout,k", CONV_SHAPES)
def test_conv1d_kernel_vs_plain_on_card(card, b, l, cin, cout, k):
    rng = np.random.default_rng(l)
    x = torch.from_numpy(rng.integers(-128, 128, (b, l, cin), dtype=np.int8)).to(card)
    w = torch.from_numpy(rng.integers(-128, 128, (k, cin, cout), dtype=np.int8)).to(card)
    xs = torch.from_numpy(rng.uniform(1e-3, 1e-1, (b, 1)).astype(np.float32)).to(card)
    ws = torch.from_numpy(rng.uniform(1e-3, 1e-1, (cout,)).astype(np.float32)).to(card)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(card)
    assert _bits_equal(conv1d_fused_q(x, w, xs, ws, return_acc=True),
                       conv1d_fused_q_plain(x, w, xs, ws, return_acc=True))
    got = conv1d_fused_q(x, w, xs, ws, bias, act="relu")
    torch.cuda.synchronize()
    assert _bits_equal(got, conv1d_fused_q_plain(x, w, xs, ws, bias, act="relu"))


def _epilogue_cases(x, w, rng, card, per_row, shape):
    """(x_scale, w_scale, bias) on the card: x_scale per row or one value."""
    n = w.shape[-1]
    xs = rng.uniform(1e-3, 1e-1, shape if per_row else ()).astype(np.float32)
    ws = rng.uniform(1e-3, 1e-1, (n,)).astype(np.float32)
    bias = (rng.standard_normal(n) * 3).astype(np.float32)
    return [torch.from_numpy(np.asarray(a)).to(card) for a in (xs, ws, bias)]


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 9, 64, 8768])
@pytest.mark.parametrize("k,n", [(8704, 64), (37, 5), (64, 2), (384, 256)])
def test_quant_matmul_edges_on_card(card, m, k, n):
    """Rows on both sides of the 8-row and 64-row tiles, split and unsplit
    K, ragged K and N (byte staging), per-row and per-tensor x scales."""
    rng = np.random.default_rng(m * 7 + k + n)
    x, w = (torch.from_numpy(rng.integers(-128, 128, s, dtype=np.int8)).to(card)
            for s in ((m, k), (k, n)))
    per_row = m % 2 == 0
    xs, ws, b = _epilogue_cases(x, w, rng, card, per_row, (m, 1))
    ws = ws.reshape(1, n)
    assert _bits_equal(quant_matmul(x, w, xs, ws, return_acc=True),
                       quant_matmul_plain(x, w, xs, ws, return_acc=True))
    for kw in (dict(act="relu", clip=0.5), dict(act=None)):
        got = quant_matmul(x, w, xs, ws, b, **kw)
        torch.cuda.synchronize()
        assert _bits_equal(got, quant_matmul_plain(x, w, xs, ws, b, **kw)), kw


@pytest.mark.gpu
def test_quant_matmul_split_workspace_left_clean_on_card(card):
    """A split call is one launch, and leaves its workspace and counters at
    zero for the next call on the stream."""
    rng = np.random.default_rng(35072)
    assert tqmm.qmm_tiling(8, 35072, 64).splits > 1
    for _ in range(3):
        x, w = (torch.from_numpy(rng.integers(-128, 128, s, dtype=np.int8)).to(card)
                for s in ((8, 35072), (35072, 64)))
        one = torch.ones((1, 1), device=card)
        before = quant_matmul.launches
        got = quant_matmul(x, w, one, one, return_acc=True)
        torch.cuda.synchronize()
        assert quant_matmul.launches == before + 1
        assert _bits_equal(got, quant_matmul_plain(x, w, one, one, return_acc=True))
        work, counters = tqmm._scratch[(x.device, torch.cuda.current_stream().cuda_stream)]
        assert not work.any() and not counters.any()


@pytest.mark.gpu
@pytest.mark.parametrize("cin", [1, 4, 5, 31, 32, 33, 200])
@pytest.mark.parametrize("l", [1, 63, 274, 1096])
def test_conv1d_edges_on_card(card, cin, l):
    """The tensor-core path at ragged Cin (zero-padded in shared memory), L
    on both sides of the row tiles and 'same' halos for K in {1, 3, 5}."""
    k = (1, 3, 5)[(cin + l) % 3]
    cout = (8, 70, 64, 33)[(cin * 3 + l) % 4]
    b = 2
    rng = np.random.default_rng(cin * 1000 + l)
    x = torch.from_numpy(rng.integers(-128, 128, (b, l, cin), dtype=np.int8)).to(card)
    w = torch.from_numpy(rng.integers(-128, 128, (k, cin, cout), dtype=np.int8)).to(card)
    xs, ws, bias = _epilogue_cases(x, w, rng, card, l % 2 == 0, (b, 1))
    assert _bits_equal(conv1d_fused_q(x, w, xs, ws, return_acc=True),
                       conv1d_fused_q_plain(x, w, xs, ws, return_acc=True))
    for kw in (dict(act="relu", clip=0.5), dict(act=None)):
        got = conv1d_fused_q(x, w, xs, ws, bias, **kw)
        torch.cuda.synchronize()
        assert _bits_equal(got, conv1d_fused_q_plain(x, w, xs, ws, bias, **kw)), kw


@pytest.mark.gpu
@pytest.mark.parametrize("cols", [1, 2, 5, 31, 32, 33, 40, 100, 1024, 1025, 2048, 4096])
def test_cordic_softmax_kernel_vs_plain_on_card(card, cols):
    """Both sides of the kernel's register path (cols <= 32) and its block
    per wider row (several levels of windows beyond 1,024 columns)."""
    rng = np.random.default_rng(cols)
    x = torch.from_numpy((rng.standard_normal((37, cols)) * 20).astype(np.float32)).to(card)
    got = tcordic.cordic_softmax(x)
    torch.cuda.synchronize()
    assert _bits_equal(got, tcordic.cordic_softmax_plain(x))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", tcordic.MODES)
def test_cordic_activation_kernel_vs_plain_on_card(card, mode):
    rng = np.random.default_rng(len(mode))
    edges = [4.4, -4.4, 4.3999996, -4.3999996, 30.5, -30.5, -0.0, 0.0, 1e-30, -1e-30, 1e4, -1e4]
    for x in (rng.uniform(-4, 4, (4096, 128)), rng.uniform(-40, 40, (3, 5, 7)), np.array(edges)):
        xt = torch.from_numpy(x.astype(np.float32)).to(card)
        before = tcordic.cordic_activation.launches
        got = tcordic.cordic_activation(xt, mode)
        torch.cuda.synchronize()
        assert tcordic.cordic_activation.launches == before + 1
        assert _bits_equal(got, tcordic.apply_mode(xt, mode))


@pytest.mark.gpu
def test_cordic_softmax_refuses_wide_rows_on_card(card):
    """Kernel K3 holds a row's first-level window sums in shared memory:
    rows up to 32,768 values; wider rows raise rather than fall back."""
    x = torch.zeros((2, tcordic.K3_MAX_COLS + 1), device=card)
    with pytest.raises(ValueError, match="up to 32768"):
        tcordic.cordic_softmax(x)
    got = tcordic.cordic_softmax(x[:, :-1])
    torch.cuda.synchronize()
    assert _bits_equal(got, tcordic.cordic_softmax_plain(x[:, :-1]))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", tcordic.MODES)
def test_cordic_activation_every_angle_on_card(card, mode):
    """Every Q15.16 angle the mode can feed the CORDIC, on the FP32-pipe stages."""
    x = tcordic.angle_grid(mode).to(card)
    got = tcordic.cordic_activation(x, mode)
    torch.cuda.synchronize()
    assert _bits_equal(got, tcordic.apply_mode(x, mode))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", tcordic.MODES)
def test_cordic_activation_ragged_and_offset_on_card(card, mode):
    """Sizes around one 16-byte vector, and views at 1- and 3-float offsets:
    the kernel's scalar head and tail beside its vector loads."""
    rng = np.random.default_rng(7)
    flat = torch.from_numpy(rng.uniform(-6, 6, 4096 * 128).astype(np.float32)).to(card)
    views = [flat[:size] for size in (1, 3, 4, 5, 33, 1000)]
    views += [flat[1:], flat[3:-2], flat[1:6], flat[2:3]]
    for x in views:
        got = tcordic.cordic_activation(x, mode)
        torch.cuda.synchronize()
        assert _bits_equal(got, tcordic.apply_mode(x, mode)), (x.numel(), x.storage_offset())


@pytest.mark.gpu
def test_frontend_primitives_vs_plain_on_card(card):
    rng = np.random.default_rng(0)
    for r, k, n in ((408, 513, 64), (408, 64, 20), (5, 1, 7)):
        x = torch.from_numpy(rng.standard_normal((r, k)).astype(np.float32)).to(card)
        m = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(card)
        assert _bits_equal(frontend.project_rows(x, m), frontend.project_rows_plain(x, m))
    for r, n in ((8, 1096), (4104, 51), (4104, 12), (3, 1), (300, 7), (130, 32), (2, 33),
                 (2, 65), (5, 100), (9, 2048), (3, 2049), (3, 4104), (1, frontend.MAX_ROW)):
        x = torch.from_numpy(rng.standard_normal((r, n)).astype(np.float32)).to(card)
        assert _bits_equal(frontend.row_sum(x), frontend.row_sum_plain(x)), (r, n)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 13, 1025, 2047])
def test_project_rows_ragged_with_every_tile_on_card(card, monkeypatch, k):
    """K on both sides of a chunk (the split and its finish), N around the
    16-byte vectors and the tiles, R of 1 and 7 rows: the chosen tile and
    every other tile give the plain twin's bits, one launch a call."""
    rng = np.random.default_rng(k)
    chosen = frontend.project_tiling
    for r in (1, 7):
        for n in (1, 2, 20, 33):
            x = torch.from_numpy(rng.standard_normal((r, k)).astype(np.float32)).to(card)
            m = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(card)
            want = frontend.project_rows_plain(x, m)
            for tile in [None, *range(len(frontend.PROJECT_TILES))]:
                monkeypatch.setattr(frontend, "project_tiling", chosen if tile is None else
                                    lambda *a, t=tile: frontend.tiling_with(t, *a))
                before = frontend.project_rows.launches
                got = frontend.project_rows(x, m)
                torch.cuda.synchronize()
                assert frontend.project_rows.launches == before + 1
                assert _bits_equal(got, want), (r, k, n, tile)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(FEATURE_DIMS))
def test_feature_rows_independent_of_co_batch_on_card(card, kind):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((8, N_SAMPLES)) * 10.0 ** rng.uniform(-2, 2, (8, 1))
    x = torch.from_numpy(w.astype(np.float32)).to(card)
    full = features_torch.feature_rows(x, kind)
    perm = torch.from_numpy(rng.permutation(8)).to(card)
    assert _bits_equal(full[perm], features_torch.feature_rows(x[perm], kind))
    for size in (1, 3):
        assert _bits_equal(full[:size], features_torch.feature_rows(x[:size], kind))
    padded = torch.cat([x[:3], torch.zeros((5, N_SAMPLES), device=card)])
    assert _bits_equal(full[:3], features_torch.feature_rows(padded, kind)[:3])


@pytest.mark.gpu
@pytest.mark.parametrize("r,k,n", [(8, 35072, 64), (8, 8704, 64), (8, 64, 2), (8768, 3, 64)])
def test_project_rows_at_float_layer_shapes_on_card(card, r, k, n):
    """The float layers' sums: dense0 at full and pruned width, dense1, and
    conv0's im2col rows."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((r, k)).astype(np.float32)).to(card)
    m = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(card)
    before = frontend.project_rows.launches
    got = frontend.project_rows(x, m)
    torch.cuda.synchronize()
    assert frontend.project_rows.launches == before + 1
    assert _bits_equal(got, frontend.project_rows_plain(x, m))
    assert _bits_equal(frontend.project_rows(x, m), got)  # the split's finish is deterministic


def _canonical_artifact(policy, device):
    from repro_torch.core.precision_policy import PrecisionPolicy
    from repro_torch.models import cnn1d
    from repro_torch.serving.quantized_params import quantize_params

    cfg = cnn1d.CNNConfig()
    params = cnn1d.init_params(cfg, torch.Generator().manual_seed(11))
    return cfg, quantize_params(params, cfg, mode="int8", device=device,
                                policy=PrecisionPolicy.parse(policy, default="int8"))


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["dense0/w=fp32", "dense0/w=bf16"])
def test_float_dense_rows_independent_of_co_batch_and_equal_cpu_on_card(card, policy):
    from repro_torch.serving import accelerator as tacc

    cfg, qp = _canonical_artifact(policy, card)
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((8, cfg.input_len))
                          * 10.0 ** rng.uniform(-2, 2, (8, 1))).astype(np.float32)).to(card)
    full = tacc.accelerator_forward(qp, x, cfg, device=card)
    for size in (1, 3):
        assert _bits_equal(full[:size], tacc.accelerator_forward(qp, x[:size], cfg, device=card))
    perm = torch.from_numpy(rng.permutation(8)).to(card)
    assert _bits_equal(full[perm], tacc.accelerator_forward(qp, x[perm], cfg, device=card))
    cpu = tacc.accelerator_forward(qp.to("cpu"), x.cpu(), cfg, device="cpu")
    assert _bits_equal(full.cpu(), cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4])
def test_sharded_forward_over_one_card_equals_unsharded(card, k):
    from repro_torch.distributed.sharding import StreamMesh
    from repro_torch.serving import accelerator as tacc

    cfg, qp = _canonical_artifact("conv0/w=bf16,dense1/w=fp32", card)
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((8, cfg.input_len)).astype(np.float32)).to(card)
    want = tacc.accelerator_forward(qp, x, cfg, device=card)
    got = tacc.accelerator_forward_sharded(qp, x, cfg, mesh=StreamMesh((card,) * k))
    assert _bits_equal(want, got)
