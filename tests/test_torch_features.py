"""The port's on-device DSP front-end against the numpy oracle and JAX.

``repro_torch.data.features_torch`` (on the CPU, through the plain versions
of its fixed-order primitives) is held within the reference's per-kind
``PARITY_ATOL`` of the float64 numpy oracle and of
``repro.data.features_jax``; its float32 constants equal the reference's
bitwise; and each row's bits do not depend on its co-batch (permutation,
batch size 1/3/8, silence padding).  The fixed-order row sum reproduces
XLA's CPU reduction bits where its docstring says it does, which is what
makes the zcr front-end, and with it the golden ``int8_ondevice`` cell,
bitwise equal to the reference.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import features as jfeatures  # noqa: E402
from repro.data import features_jax  # noqa: E402
from repro_torch.data import acoustic, features, features_torch  # noqa: E402
from repro_torch.kernels import frontend, xla_sum  # noqa: E402

torch.set_num_threads(1)

KINDS = sorted(features.FEATURE_DIMS)


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _windows(n: int, seed: int) -> np.ndarray:
    """UAV, background and noise windows with a 10^4 loudness spread."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        if i % 3 == 0:
            w = acoustic.synth_uav(rng)
        elif i % 3 == 1:
            w = acoustic.synth_background(rng)
        else:
            w = rng.standard_normal(features.N_SAMPLES)
        rows.append(np.asarray(w, np.float32))
    return np.stack(rows) * (10.0 ** rng.uniform(-2, 2, size=(n, 1))).astype(np.float32)


def _rows(x: np.ndarray, kind: str) -> np.ndarray:
    return features_torch.feature_rows(torch.from_numpy(x), kind).numpy()


@pytest.mark.parametrize("kind", KINDS)
def test_parity_with_numpy_oracle(kind):
    x = _windows(6, seed=3)
    got = _rows(x, kind)
    want = features.batch_features(x, kind)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert float(np.abs(got - want).max()) <= features_torch.PARITY_ATOL[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_parity_with_reference_front_end(kind):
    x = _windows(5, seed=11)
    got = _rows(x, kind)
    want = np.asarray(features_jax.feature_rows(jnp.asarray(x), kind))
    assert float(np.abs(got - want).max()) <= features_torch.PARITY_ATOL[kind]
    if kind == "zcr":  # exact sign rule and reduction order: the same bits
        assert _bits_equal(want, got)


@pytest.mark.parametrize("kind", KINDS)
def test_constants_equal_reference(kind):
    assert _bits_equal(features_jax._hann32(1024), features_torch.hann32(1024).numpy())
    assert np.array_equal(features_jax._frame_idx(features.N_SAMPLES, 1024, 256),
                          features_torch.frame_idx(features.N_SAMPLES, 1024, 256).numpy())
    n_mels = {"mel128": 128}.get(kind, 64)
    assert _bits_equal(features_jax._mel32(n_mels), features_torch.mel32(n_mels).numpy())
    assert _bits_equal(features_jax._dct32(20, 64), features_torch.dct32(20, 64).numpy())
    # the port's own numpy oracle is the reference's, number for number
    assert _bits_equal(jfeatures.mel_filterbank(n_mels), features.mel_filterbank(n_mels))
    assert _bits_equal(jfeatures.dct_ii(20, 64), features.dct_ii(20, 64))


@pytest.mark.parametrize("kind", KINDS)
def test_rows_independent_of_co_batch(kind):
    x = _windows(8, seed=5)
    full = _rows(x, kind)
    perm = np.random.default_rng(1).permutation(8)
    assert _bits_equal(full[perm], _rows(x[perm], kind))
    for size in (1, 3):
        for i in range(0, 8 - size + 1, size):
            assert _bits_equal(full[i : i + size], _rows(x[i : i + size], kind))
    padded = np.concatenate([x[:3], np.zeros((5, x.shape[1]), np.float32)])
    got = _rows(padded, kind)
    assert _bits_equal(full[:3], got[:3]) and np.isfinite(got).all()


def test_batch_entry_point_and_validation():
    x = _windows(2, seed=8)
    got = features_torch.batch_features_torch(x, "psd", device="cpu")
    assert got.device.type == "cpu" and _bits_equal(got.numpy(), _rows(x, "psd"))
    assert features_torch.feature_rows(torch.zeros((0, features.N_SAMPLES)), "zcr").shape == (0, 128)
    with pytest.raises(ValueError, match="unknown feature kind"):
        features_torch.feature_rows(torch.from_numpy(x), "mfcc13")
    with pytest.raises(ValueError, match="windows expected"):
        features_torch.feature_rows(torch.from_numpy(x[0]), "zcr")
    assert features_torch.PARITY_ATOL == features_jax.PARITY_ATOL


@pytest.mark.parametrize(
    "n", [1, 12, 33, 51, 64, 96, 100, 128, 512, 1020, 1024, 1096, 4104, 32768])
def test_row_sum_has_the_reference_reduction_bits(n):
    """Rows of every length up to ``MAX_ROW`` sum to XLA's CPU bits (windows
    of exactly 32, the padding split between both ends, level after level);
    the mean is that sum times float32(1/n)."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((5, n)) * rng.uniform(0.1, 10, (5, 1))).astype(np.float32)
    got = frontend.row_sum(torch.from_numpy(x)).numpy()
    assert _bits_equal(np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(x)), got)
    mean = frontend.row_mean(torch.from_numpy(x)).numpy()
    assert _bits_equal(np.asarray(jax.jit(lambda a: jnp.mean(a, axis=1))(x)), mean)


def test_normalize_has_the_reference_bits_at_mfcc20_width():
    """The zero-mean, unit-RMS step over 1,096-value mfcc20 rows (two row
    means of 35 windows each) equals the reference's bitwise."""
    rng = np.random.default_rng(1096)
    v = (rng.standard_normal((64, 1096)) * rng.uniform(0.01, 30, (64, 1))
         + rng.uniform(-5, 5, (64, 1))).astype(np.float32)
    want = np.asarray(jax.jit(features_jax._normalize)(v))
    assert _bits_equal(want, features_torch._normalize(torch.from_numpy(v)).numpy())


def test_row_sum_windows_and_projection_order():
    # (windows, low padding) of one level: windows of exactly 32 past 32 values
    assert [xla_sum.window_split(n) for n in (1, 32, 33, 64, 65, 1096, 32768)] == [
        (1, 0), (1, 0), (2, 15), (2, 0), (3, 15), (35, 12), (1024, 0)]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 1096)).astype(np.float32)
    np.testing.assert_allclose(frontend.row_sum(torch.from_numpy(x)).numpy(),
                               x.astype(np.float64).sum(axis=1), rtol=1e-5, atol=1e-4)
    a = rng.standard_normal((9, 13)).astype(np.float32)
    m = rng.standard_normal((13, 4)).astype(np.float32)
    want = np.zeros((9, 4), np.float32)
    for k in range(13):  # ascending k, each product and sum rounded
        want = want + a[:, k : k + 1] * m[k : k + 1]
    assert _bits_equal(want, frontend.project_rows(torch.from_numpy(a), torch.from_numpy(m)).numpy())
    with pytest.raises(ValueError, match="expected"):
        frontend.project_rows(torch.from_numpy(a), torch.from_numpy(m[:5]))
