"""``project_rows``'s order of additions, on the CPU: chunks of
``PROJECT_CHUNK`` values of ``k``, each summed from 0 in ascending ``k``,
the chunk partials added left to right.

The plain twin is held bitwise to a numpy loop that spells the order out,
at ``K`` on both sides of a chunk and at ragged ``R`` and ``N``; for ``K <=
PROJECT_CHUNK`` it is one ascending chain, so the front-end's projections
and the deployed cells keep their bits.  A float dense0 at the canonical
width (``K`` = 35,072, 35 chunks) is held to the JAX reference within
``MIXED_PROB_ATOL`` on the probabilities with the same decisions, and its
logits within ``1e-5`` of the largest logit of those a single ascending
chain gives.  The card's kernel is held to the same twin by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.precision_policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import cnn1d as jcnn  # noqa: E402
from repro.serving import quantized_params as jqp  # noqa: E402
from repro.serving.accelerator import accelerator_forward as j_forward  # noqa: E402
from repro_torch.core.precision_policy import PrecisionPolicy  # noqa: E402
from repro_torch.kernels import frontend  # noqa: E402
from repro_torch.models import cnn1d as tcnn  # noqa: E402
from repro_torch.serving import accelerator as tacc  # noqa: E402
from repro_torch.serving.quantized_params import quantize_params  # noqa: E402

torch.set_num_threads(1)

#: as in tests/test_torch_forward.py: the largest |dp| of a float layer's
#: cell against the reference
MIXED_PROB_ATOL = 5e-5
#: the chunked logits against a single ascending chain's, relative to the
#: largest logit: two orders of one fp32 sum over 35,072 products
LOGIT_RTOL = 1e-5


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _chain(x, m, k0, k1):
    """``sum over k0 <= k < k1 of x[:, k] * m[k]`` from 0, ascending, each
    product and sum rounded to float32."""
    acc = np.zeros((x.shape[0], m.shape[1]), np.float32)
    for k in range(k0, k1):
        acc = acc + x[:, k : k + 1] * m[k : k + 1]
    return acc


def _spelled(x, m, chunk=1024):
    """The order spelled out: each chunk's chain, then the partials left to
    right from the first."""
    k = x.shape[1]
    parts = [_chain(x, m, c, min(k, c + chunk)) for c in range(0, max(k, 1), chunk)]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _operands(r, k, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((r, k)) * rng.uniform(0.1, 10, (r, 1))).astype(np.float32)
    return x, rng.standard_normal((k, n)).astype(np.float32)


@pytest.mark.parametrize("k", [1, 13, 513, 1024, 1025, 2047, 8704, 35072])
@pytest.mark.parametrize("r,n", [(1, 1), (3, 5), (7, 33)])
def test_plain_twin_has_the_chunked_order(k, r, n):
    x, m = _operands(r, k, n, seed=k + 100 * r + n)
    got = frontend.project_rows_plain(torch.from_numpy(x), torch.from_numpy(m)).numpy()
    assert _bits_equal(_spelled(x, m), got)
    assert _bits_equal(got, frontend.project_rows(torch.from_numpy(x), torch.from_numpy(m)).numpy())


@pytest.mark.parametrize("k", [1, 3, 64, 192, 384, 513, 1024])
def test_one_chunk_is_one_ascending_chain(k):
    """K of the front-end (513, 64), the float convs' im2col widths (3,
    192, 384) and the canonical dense1 (64): the bits of one chain."""
    x, m = _operands(9, k, 20, seed=k)
    got = frontend.project_rows_plain(torch.from_numpy(x), torch.from_numpy(m)).numpy()
    assert frontend.project_chunks(k) == 1
    assert _bits_equal(_chain(x, m, 0, k), got)


def test_chunks_tiles_and_the_library_check():
    assert frontend.PROJECT_CHUNK == 1024
    assert [frontend.project_chunks(k) for k in (0, 1, 1024, 1025, 8704, 35072)] == [
        1, 1, 1, 2, 9, 35]
    x, m = torch.zeros((2, 0)), torch.zeros((0, 3))
    assert _bits_equal(frontend.project_rows(x, m).numpy(), np.zeros((2, 3), np.float32))
    tiles = {shape: frontend.PROJECT_TILES[frontend.project_tiling(*shape).tile]
             for shape in ((8, 35072, 64), (8, 8704, 64), (408, 513, 64), (408, 64, 20),
                           (8, 64, 2), (8768, 3, 64))}
    assert tiles == {(8, 35072, 64): (8, 8, 1, 1), (8, 8704, 64): (8, 8, 1, 1),
                     (408, 513, 64): (8, 16, 1, 1), (408, 64, 20): (16, 32, 2, 2),
                     (8, 64, 2): (8, 16, 1, 1), (8768, 3, 64): (32, 64, 4, 4)}
    t = frontend.project_tiling(8, 35072, 64)
    assert (t.row_tiles, t.col_tiles, t.chunks, t.blocks) == (1, 8, 35, 280)

    class Library:  # a kernel library built with another chunk
        @staticmethod
        def project_rows_chunk():
            return 512

    with pytest.raises(RuntimeError, match="chunks of 512"):
        frontend._check_chunk(Library())


def _float_dense0(policy, seed=3):
    """JAX's and the port's canonical detector (flatten 35,072) with a float
    dense0, from the same fp32 params."""
    jcfg, tcfg = jcnn.CNNConfig(), tcnn.CNNConfig()
    np_params = jax.tree.map(np.asarray, jcnn.init_params(jax.random.PRNGKey(seed), jcfg))
    jart = jqp.quantize_params(jax.tree.map(jnp.asarray, np_params), jcfg, mode="int8",
                               policy=JPolicy.parse(policy, default="int8"))
    tart = quantize_params(tcnn.params_from_numpy(np_params), tcfg, mode="int8", device="cpu",
                           policy=PrecisionPolicy.parse(policy, default="int8"))
    return jcfg, jart, tcfg, tart


@pytest.mark.parametrize("policy", ["dense0/w=fp32", "dense0/w=bf16"])
def test_float_dense0_at_canonical_width_vs_reference(monkeypatch, policy):
    """K = 35,072 in 35 chunks, 1 and 8 rows: probabilities within
    ``MIXED_PROB_ATOL`` of JAX's, the same decisions, and logits within
    ``LOGIT_RTOL`` of the largest logit of the single-chain order's."""
    jcfg, jart, tcfg, tart = _float_dense0(policy)
    assert tart.layer_modes[1][0] == policy[-4:] and tart.denses[0]["w"].shape[0] == 35072
    rng = np.random.default_rng(35072)
    x = rng.standard_normal((8, tcfg.input_len)).astype(np.float32)
    x *= (10.0 ** rng.uniform(-2, 2, (8, 1))).astype(np.float32)
    want = np.asarray(j_forward(jart, jnp.asarray(x), jcfg, interpret=True))
    for rows in (x[:1], x):
        got = tacc.accelerator_forward(tart, rows, tcfg, device="cpu").numpy()
        np.testing.assert_allclose(got, want[: len(rows)], rtol=0, atol=MIXED_PROB_ATOL)
        np.testing.assert_array_equal(got.argmax(axis=1), want[: len(rows)].argmax(axis=1))
    monkeypatch.setattr(tacc, "cordic_softmax", lambda h: h)  # logits out
    chunked = tacc.accelerator_forward(tart, x, tcfg, device="cpu").numpy()
    monkeypatch.setattr(frontend, "PROJECT_CHUNK", 1 << 30)  # one chain
    chain = tacc.accelerator_forward(tart, x, tcfg, device="cpu").numpy()
    assert np.isfinite(chunked).all()
    np.testing.assert_allclose(chunked, chain, rtol=0, atol=LOGIT_RTOL * np.abs(chain).max())
