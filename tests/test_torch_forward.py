"""The port's kernel-datapath forward against the JAX reference.

The golden artifacts replay bitwise, ``detector_pruned_mixed`` included,
and ``detector_int8_ondevice`` through the raw-window forward (the port's
zcr front-end gives the reference's bits).  Forwards from the same fp32
params match the reference bitwise in the int8 and fxp8 cells.

The bf16/fp32 layers do not sum in the reference's order.  The port sums
each of them in one fixed order that depends on ``K`` alone
(``project_rows``: ascending ``k`` within chunks of 1,024, the chunk
partials left to right, so one ascending chain up to ``K`` = 1,024), on
both devices and at every batch size, so a row's bits never depend on its
co-batch and the card gives the CPU's bits; XLA's ``einsum`` and conv on
the CPU add in an order of their own, which changes with the batch size.
The mixed cells therefore agree with the reference within
:data:`MIXED_PROB_ATOL` on the probabilities, with the same decisions; at
the small widths below the CORDIC softmax's Q15.16 input absorbs the
difference and the probabilities are bitwise the reference's.  Every
row's result, logits included, is independent of its co-batch.
"""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.precision_policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.pruning import plan_prune as j_plan  # noqa: E402
from repro.data.features import FEATURE_DIMS, N_SAMPLES  # noqa: E402
from repro.models import cnn1d as jcnn  # noqa: E402
from repro.serving import quantized_params as jqp  # noqa: E402
from repro.serving.accelerator import accelerator_forward as j_forward  # noqa: E402
from repro_torch.core.precision_policy import PrecisionPolicy  # noqa: E402
from repro_torch.core.pruning import plan_prune  # noqa: E402
from repro_torch.data.features_torch import feature_rows  # noqa: E402
from repro_torch.distributed.sharding import STREAM_AXIS, stream_mesh  # noqa: E402
from repro_torch.models import cnn1d as tcnn  # noqa: E402
from repro_torch.serving import accelerator as tacc  # noqa: E402
from repro_torch.serving.quantized_params import load_artifact, quantize_params  # noqa: E402

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parents[1] / "artifacts" / "golden"
SMALL = dict(input_len=FEATURE_DIMS["zcr"], channels=(4, 8), hidden=8)
MIXED = "conv0/w=bf16,dense1/w=fp32"
#: the largest |dp| of a mixed cell against the reference, stated from a
#: measurement: the canonical pruned_mixed cell over 25 seeds x 1-8 rows of
#: loudness-spread inputs differed by at most 5.5e-6 (and in 11 of 200
#: forwards at all), so 5e-5 leaves a tenfold margin
MIXED_PROB_ATOL = 5e-5


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _inputs(rows=8, width=SMALL["input_len"], seed=1234):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, width)).astype(np.float32)
    return x * (10.0 ** rng.uniform(-2, 2, size=(rows, 1))).astype(np.float32)


@pytest.mark.parametrize("name", ["int8", "pruned_mixed", "int8_ondevice"])
def test_golden_artifacts_replay_bitwise(name):
    raw = name == "int8_ondevice"
    x = np.load(GOLDEN / ("input_windows.npy" if raw else "input.npy"))
    qp = load_artifact(GOLDEN / f"detector_{name}.npz", device="cpu")
    assert qp.feature_kind == ("zcr" if raw else None)
    cfg = tcnn.CNNConfig(input_len=FEATURE_DIMS["zcr"], channels=(4, 8), hidden=8)
    got = tacc.accelerator_forward(qp, x, cfg, device="cpu", raw_windows=raw)
    assert _bits_equal(np.load(GOLDEN / f"expected_{name}.npy"), got.numpy())


def _bake_both(cell, seed=7, channels=(4, 8), hidden=8, feature_kind=None):
    jcfg = jcnn.CNNConfig(input_len=SMALL["input_len"], channels=channels, hidden=hidden)
    tcfg = tcnn.CNNConfig(input_len=SMALL["input_len"], channels=channels, hidden=hidden)
    np_params = jax.tree.map(np.asarray, jcnn.init_params(jax.random.PRNGKey(seed), jcfg))
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = tcnn.params_from_numpy(np_params)
    last = f"conv{len(channels) - 1}"
    if cell == "pruned_mixed":
        keep = channels[-1] // 2
        jkw = dict(prune=j_plan(jp[last]["w"], jcfg.n_frames, keep=keep, trim_frames=1),
                   policy=JPolicy.parse(MIXED, default="int8"))
        tkw = dict(prune=plan_prune(tp[last]["w"], tcfg.n_frames, keep=keep, trim_frames=1),
                   policy=PrecisionPolicy.parse(MIXED, default="int8"))
        mode = "int8"
    else:
        jkw, tkw, mode = {}, {}, cell
    return (
        jcfg, jqp.quantize_params(jp, jcfg, mode=mode, feature_kind=feature_kind, **jkw),
        tcfg, quantize_params(tp, tcfg, mode=mode, device="cpu", feature_kind=feature_kind, **tkw),
    )


@pytest.mark.parametrize("cell", ["int8", "fxp8"])
@pytest.mark.parametrize("per_sample", [True, False])
def test_forward_bitwise_vs_reference(cell, per_sample):
    jcfg, jart, tcfg, tart = _bake_both(cell)
    x = _inputs(rows=6)
    want = j_forward(jart, jnp.asarray(x), jcfg, interpret=True, per_sample_acts=per_sample)
    got = tacc.accelerator_forward(tart, x, tcfg, device="cpu", per_sample_acts=per_sample)
    assert _bits_equal(want, got.numpy())


def test_forward_from_fp32_params_bakes_on_the_fly():
    jcfg, _, tcfg, _ = _bake_both("int8")
    np_params = jax.tree.map(np.asarray, jcnn.init_params(jax.random.PRNGKey(3), jcfg))
    x = _inputs(rows=3)
    for fxp in (False, True):
        want = j_forward(jax.tree.map(jnp.asarray, np_params), jnp.asarray(x), jcfg,
                         fxp=fxp, interpret=True)
        got = tacc.accelerator_forward(tcnn.params_from_numpy(np_params), x, tcfg,
                                       device="cpu", fxp=fxp)
        assert _bits_equal(want, got.numpy())


def test_forward_pruned_mixed_vs_reference():
    jcfg, jart, tcfg, tart = _bake_both("pruned_mixed", channels=(8, 16), hidden=16)
    x = _inputs(rows=5)
    want = j_forward(jart, jnp.asarray(x), jcfg, interpret=True)
    got = tacc.accelerator_forward(tart, x, tcfg, device="cpu").numpy()
    assert _bits_equal(want, got)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)


@pytest.mark.parametrize("cell", ["int8", "pruned_mixed"])
def test_rows_independent_of_co_batch(cell):
    """Slot permutation, batch size and silence padding never change a row."""
    _, _, tcfg, tart = _bake_both(cell)
    x = _inputs(rows=7, seed=99)
    full = tacc.accelerator_forward(tart, x, tcfg, device="cpu").numpy()
    perm = np.random.default_rng(0).permutation(7)
    assert _bits_equal(full[perm], tacc.accelerator_forward(tart, x[perm], tcfg, device="cpu").numpy())
    for i in range(7):
        one = tacc.accelerator_forward(tart, x[i : i + 1], tcfg, device="cpu").numpy()
        assert _bits_equal(full[i : i + 1], one)
    padded = np.concatenate([x[:3], np.zeros((5, x.shape[1]), np.float32)])
    got = tacc.accelerator_forward(tart, padded, tcfg, device="cpu").numpy()
    assert _bits_equal(full[:3], got[:3]) and np.isfinite(got).all()


def _raw_windows(rows, seed=21):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((rows, N_SAMPLES)).astype(np.float32)
    return w * (10.0 ** rng.uniform(-2, 2, size=(rows, 1))).astype(np.float32)


@pytest.mark.parametrize("cell", ["int8", "pruned_mixed"])
def test_raw_window_forward_vs_reference(cell):
    """The raw-window forward equals the reference's on the same artifact
    (zcr front-end: the same bits), and equals the forward of its own
    front-end's feature rows."""
    jcfg, jart, tcfg, tart = _bake_both(cell, feature_kind="zcr")
    w = _raw_windows(5)
    want = j_forward(jart, jnp.asarray(w), jcfg, interpret=True, raw_windows=True)
    got = tacc.accelerator_forward(tart, w, tcfg, device="cpu", raw_windows=True).numpy()
    assert _bits_equal(want, got)
    rows = feature_rows(torch.from_numpy(w), "zcr")
    assert _bits_equal(got, tacc.accelerator_forward(tart, rows, tcfg, device="cpu").numpy())
    tacc.precompile_slot_shapes(tart, tcfg, (1, 2), raw_windows=True)


def test_raw_window_contract_errors():
    _, _, tcfg, plain = _bake_both("int8")
    _, _, _, baked = _bake_both("int8", feature_kind="zcr")
    w = _raw_windows(2)
    with pytest.raises(ValueError, match="baked feature kind"):
        tacc.accelerator_forward(plain, w, tcfg, device="cpu", raw_windows=True)
    with pytest.raises(ValueError, match="baked for feature kind 'zcr'"):
        tacc.accelerator_forward(baked, w, tcfg, device="cpu", raw_windows=True,
                                 feature_kind="psd")
    with pytest.raises(ValueError, match=f"expects \\(B, {N_SAMPLES}\\)"):
        tacc.accelerator_forward(baked, w[:, :100], tcfg, device="cpu", raw_windows=True)
    # an fp32 checkpoint is baked on the fly with the given front-end
    np_params = jax.tree.map(np.asarray, jcnn.init_params(jax.random.PRNGKey(7), jcnn.CNNConfig(
        input_len=SMALL["input_len"], channels=(4, 8), hidden=8)))
    got = tacc.accelerator_forward(tcnn.params_from_numpy(np_params), w, tcfg, device="cpu",
                                   raw_windows=True, feature_kind="zcr")
    assert _bits_equal(got.numpy(), tacc.accelerator_forward(baked, w, tcfg, device="cpu",
                                                             raw_windows=True).numpy())


def test_unported_paths_raise():
    """Sharded dispatch (ROADMAP M8) is ported: it gives the unsharded bits
    and takes the reference's arguments; a row vector is still refused."""
    _, _, tcfg, tart = _bake_both("int8")
    x = _inputs(rows=2)
    mesh = stream_mesh(2, device="cpu")
    want = tacc.accelerator_forward(tart, x, tcfg, device="cpu").numpy()
    got = tacc.accelerator_forward_sharded(tart, x, tcfg, mesh=mesh, axis_name=STREAM_AXIS)
    assert _bits_equal(want, got.numpy())
    with pytest.raises(ValueError, match="feature rows"):
        tacc.accelerator_forward(tart, x[0], tcfg, device="cpu")
    tacc.precompile_slot_shapes(tart, tcfg, (1, 2, 4))
    tacc.precompile_slot_shapes(tart, tcfg, (2, 4), mesh=mesh)


def _canonical_mixed(seed):
    """JAX's and the port's artifact of the deployed cell at the canonical
    widths: pruned to keep=64 with a trimmed frame, ``MIXED`` policy."""
    jcfg, tcfg = jcnn.CNNConfig(), tcnn.CNNConfig()
    np_params = jax.tree.map(np.asarray, jcnn.init_params(jax.random.PRNGKey(seed), jcfg))
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = tcnn.params_from_numpy(np_params)
    jart = jqp.quantize_params(
        jp, jcfg, mode="int8", policy=JPolicy.parse(MIXED, default="int8"),
        prune=j_plan(jp["conv2"]["w"], jcfg.n_frames, keep=64, trim_frames=1))
    tart = quantize_params(
        tp, tcfg, mode="int8", device="cpu", policy=PrecisionPolicy.parse(MIXED, default="int8"),
        prune=plan_prune(tp["conv2"]["w"], tcfg.n_frames, keep=64, trim_frames=1))
    return jcfg, jart, tcfg, tart


@pytest.mark.parametrize("seed", [0, 16])
def test_mixed_cell_within_tolerance_of_reference_at_canonical_widths(seed):
    """The deployed pruned_mixed cell at the canonical widths (flatten
    8,704), 1-8 rows: probabilities within ``MIXED_PROB_ATOL`` of the
    reference's and the same decisions."""
    jcfg, jart, tcfg, tart = _canonical_mixed(seed)
    assert tart.layer_modes == (("bf16", "int8", "int8"), ("int8", "fp32"))
    for rows in range(1, 9):
        x = _inputs(rows=rows, width=tcfg.input_len, seed=10 * seed + rows)
        want = np.asarray(j_forward(jart, jnp.asarray(x), jcfg, interpret=True))
        got = tacc.accelerator_forward(tart, x, tcfg, device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=MIXED_PROB_ATOL)
        np.testing.assert_array_equal(got.argmax(axis=1), want.argmax(axis=1))


@pytest.mark.parametrize("policy", ["dense0/w=fp32", "dense0/w=bf16"])
def test_float_dense_rows_independent_of_co_batch_at_canonical_width(monkeypatch, policy):
    """A float dense layer at the canonical K = 35,072: each row's logits
    (the softmax's input, whose Q15.16 rounding would hide an ulp) are
    bitwise the same at batch sizes 1, 3 and 8, under a permutation and
    beside silence padding."""
    cfg = tcnn.CNNConfig()
    params = tcnn.init_params(cfg, torch.Generator().manual_seed(11))
    qp = quantize_params(params, cfg, mode="int8", device="cpu",
                         policy=PrecisionPolicy.parse(policy, default="int8"))
    assert qp.layer_modes[1][0] == policy[-4:] and qp.denses[0]["w"].shape[0] == 35072
    monkeypatch.setattr(tacc, "cordic_softmax", lambda h: h)  # logits out

    def logits(x):
        return tacc.accelerator_forward(qp, x, cfg, device="cpu").numpy()

    x = _inputs(rows=8, width=cfg.input_len, seed=5)
    full = logits(x)
    perm = np.random.default_rng(0).permutation(8)
    assert _bits_equal(full[perm], logits(x[perm]))
    assert _bits_equal(full[3:6], logits(x[3:6]))
    for i in (0, 7):
        assert _bits_equal(full[i : i + 1], logits(x[i : i + 1]))
    padded = np.concatenate([x[:3], np.zeros((5, x.shape[1]), np.float32)])
    assert _bits_equal(full[:3], logits(padded)[:3])
