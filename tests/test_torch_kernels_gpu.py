"""The CUDA kernels K1-K3 against their plain PyTorch versions, on the card.

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

from repro_torch.kernels import cordic_act as tcordic  # noqa: E402
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


@pytest.mark.gpu
@pytest.mark.parametrize("cols", [2, 5, 40])
def test_cordic_softmax_kernel_vs_plain_on_card(card, cols):
    rng = np.random.default_rng(cols)
    x = torch.from_numpy((rng.standard_normal((37, cols)) * 20).astype(np.float32)).to(card)
    got = tcordic.cordic_softmax(x)
    torch.cuda.synchronize()
    assert _bits_equal(got, tcordic.cordic_softmax_plain(x))
    with pytest.raises(NotImplementedError, match="K3b"):
        tcordic.cordic_activation(x, "tanh")
