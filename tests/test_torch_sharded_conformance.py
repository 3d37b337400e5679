"""The port's sharded dispatch (ROADMAP M8) and its conformance matrix.

Twin of ``tests/test_sharded_conformance.py`` and of the matrix in
``tests/test_pruned_serving_conformance.py``, on the same small detector
(zcr, channels (4, 8), hidden 8).  A window's probability depends only on
its own row (per-sample activation scales, and every float layer summed in
one fixed order), so however the batch is executed the bits are the same:

* the matrix {unpruned, pruned} x {int8, fxp8, mixed} x {features, raw
  windows}: batched == streamed one row at a time == streamed through the
  engine in uneven chunks (unsharded and sharded) == sharded over a mesh of
  4 CPU entries, bitwise; each equal to JAX's unsharded forward on the same
  artifact, bitwise for int8 and fxp8, within ``MIXED_PROB_ATOL`` for the
  mixed cells (in practice bitwise at these widths);
* pruned physical == masked unpruned, bitwise, for the three precision
  cells;
* a permutation that moves rows between shards gives the permuted output;
  ``stream_mesh`` and the engine refuse what the reference refuses.

A CPU mesh of ``k`` entries is the port's counterpart of the reference's
``k`` forced host devices: each entry runs its chunk of rows on its own.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.precision_policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.pruning import plan_prune as j_plan  # noqa: E402
from repro.models import cnn1d as jcnn  # noqa: E402
from repro.serving import quantized_params as jqp  # noqa: E402
from repro.serving.accelerator import accelerator_forward as j_forward  # noqa: E402
from repro_torch.core.precision_policy import PrecisionPolicy  # noqa: E402
from repro_torch.core.pruning import PruneSpec, plan_prune  # noqa: E402
from repro_torch.data import features  # noqa: E402
from repro_torch.distributed.sharding import STREAM_AXIS, StreamMesh, stream_mesh  # noqa: E402
from repro_torch.models import cnn1d as tcnn  # noqa: E402
from repro_torch.serving import accelerator as tacc  # noqa: E402
from repro_torch.serving.engine import MonitorEngine  # noqa: E402
from repro_torch.serving.quantized_params import quantize_params, replicate_params  # noqa: E402

torch.set_num_threads(1)

MIXED = "conv0/w=bf16,dense1/w=fp32"
#: the mixed cells' tolerance against the reference (tests/test_torch_forward.py)
MIXED_PROB_ATOL = 5e-5
#: the precision axis of the matrix: (cell, default mode, policy)
PRECISION_CELLS = [("int8", "int8", None), ("fxp8", "fxp8", None), ("mixed", "int8", MIXED)]
CPU4 = stream_mesh(4, device="cpu")


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def detector():
    jcfg = jcnn.CNNConfig(input_len=features.FEATURE_DIMS["zcr"], channels=(4, 8), hidden=8)
    np_params = jax.tree.map(np.asarray, jcnn.init_params(jax.random.PRNGKey(0), jcfg))
    tcfg = tcnn.CNNConfig(input_len=jcfg.input_len, channels=(4, 8), hidden=8)
    return jcfg, np_params, tcfg, tcnn.params_from_numpy(np_params)


def _bake_both(detector, prune, mode, policy, feature_kind=None):
    jcfg, np_params, tcfg, tp = detector
    jp = jax.tree.map(jnp.asarray, np_params)
    jkw, tkw = {}, {}
    if prune:
        jkw["prune"] = j_plan(jp["conv1"]["w"], jcfg.n_frames, keep=3, trim_frames=1)
        tkw["prune"] = plan_prune(tp["conv1"]["w"], tcfg.n_frames, keep=3, trim_frames=1)
    if policy is not None:
        jkw["policy"] = JPolicy.parse(policy, default=mode)
        tkw["policy"] = PrecisionPolicy.parse(policy, default=mode)
    return (jqp.quantize_params(jp, jcfg, mode=mode, feature_kind=feature_kind, **jkw),
            quantize_params(tp, tcfg, mode=mode, feature_kind=feature_kind, device="cpu", **tkw))


def _rows(rng, n, width):
    x = rng.standard_normal((n, width)).astype(np.float32)
    return x * (10.0 ** rng.uniform(-2, 2, size=(n, 1))).astype(np.float32)


def _engine_scores(tart, tcfg, audio, rng, *, raw, shards):
    """Per-stream probabilities of ``audio`` streamed through the engine in
    uneven chunks (4 slots, ``shards`` entries)."""
    eng = MonitorEngine(tart, tcfg, n_streams=audio.shape[0], feature_kind="zcr",
                        on_device_features=raw, batch_slots=4, shards=shards, device="cpu")
    scores = {s: [] for s in range(audio.shape[0])}
    cursors = [0] * audio.shape[0]
    while any(c < audio.shape[1] for c in cursors):
        for s in range(audio.shape[0]):
            n = int(rng.uniform(0.3, 1.8) * features.N_SAMPLES)
            eng.push(s, audio[s, cursors[s] : cursors[s] + n])
            cursors[s] += n
        for ws in eng.step():
            scores[ws.stream].append(ws.p_uav)
    for ws in eng.drain():
        scores[ws.stream].append(ws.p_uav)
    assert eng.dropped_samples == 0 and eng.shards == (shards or 1)
    return [np.asarray(v, np.float64) for v in scores.values()]


@pytest.mark.parametrize("raw", [False, True], ids=["features", "raw_windows"])
@pytest.mark.parametrize("cell,mode,policy", PRECISION_CELLS)
@pytest.mark.parametrize("prune", [False, True], ids=["unpruned", "pruned"])
def test_matrix_batched_streamed_sharded_bitwise_equal(detector, prune, cell, mode, policy, raw):
    """One cell of the matrix: batched == row by row == engine (unsharded
    and over 4 CPU entries) == sharded forward, bitwise; and the reference's
    unsharded forward on the same artifact."""
    jcfg, _, tcfg, _ = detector
    jart, tart = _bake_both(detector, prune, mode, policy, feature_kind="zcr" if raw else None)
    assert tart.mixed == (cell == "mixed") and tart.pruned == prune
    rng = np.random.default_rng(17)
    x = _rows(rng, 4, features.N_SAMPLES if raw else tcfg.input_len)

    batched = tacc.accelerator_forward(tart, x, tcfg, device="cpu", raw_windows=raw).numpy()
    sharded = tacc.accelerator_forward_sharded(tart, x, tcfg, mesh=CPU4, raw_windows=raw)
    assert _bits_equal(batched, sharded.numpy())
    for i in range(x.shape[0]):
        row = tacc.accelerator_forward(tart, x[i : i + 1], tcfg, device="cpu", raw_windows=raw)
        assert _bits_equal(batched[i : i + 1], row.numpy())

    want = np.asarray(j_forward(jart, jnp.asarray(x), jcfg, interpret=True, raw_windows=raw))
    if cell == "mixed":
        np.testing.assert_allclose(batched, want, rtol=0, atol=MIXED_PROB_ATOL)
        np.testing.assert_array_equal(batched.argmax(axis=1), want.argmax(axis=1))
    else:
        assert _bits_equal(want, batched)

    # the engine, streamed in uneven chunks, unsharded and over 4 entries:
    # each stream's scores are one batched forward of its windows
    n_streams, n_win = 3, 2
    audio = _rows(rng, n_streams, n_win * features.N_SAMPLES)
    ref = []
    for s in range(n_streams):
        wins = audio[s].reshape(n_win, features.N_SAMPLES)
        rows = wins if raw else features.batch_features(wins, "zcr")
        probs = tacc.accelerator_forward(tart, rows, tcfg, device="cpu", raw_windows=raw)
        ref.append(probs.numpy()[:, 1].astype(np.float64))
    for shards in (None, 4):
        got = _engine_scores(tart, tcfg, audio, np.random.default_rng(5), raw=raw, shards=shards)
        for s in range(n_streams):
            assert _bits_equal(got[s], ref[s]), (shards, s)


def _masked_setup(params, cfg, spec):
    """Full-size params with the pruned channels and dense rows zeroed, and
    the frame-only spec that trims the same boundary frame."""
    n_ch = cfg.channels[-1]
    last = f"conv{len(cfg.channels) - 1}"
    mask = torch.zeros(n_ch)
    mask[torch.from_numpy(np.asarray(spec.keep_channels))] = 1.0
    masked = {k: dict(v) for k, v in params.items()}
    masked[last]["w"] = params[last]["w"] * mask[None, None, :]
    masked[last]["b"] = params[last]["b"] * mask
    wd = params["dense0"]["w"].reshape(cfg.n_frames, n_ch, -1).clone()
    dropped = np.setdiff1d(np.arange(n_ch), np.asarray(spec.keep_channels))
    wd[:, torch.from_numpy(dropped), :] = 0.0
    masked["dense0"]["w"] = wd.reshape(cfg.flatten_size, -1)
    frame_spec = PruneSpec(
        keep_channels=np.arange(n_ch), keep_frames=np.asarray(spec.keep_frames),
        flatten_before=cfg.flatten_size, flatten_after=len(spec.keep_frames) * n_ch,
    )
    return masked, frame_spec


@pytest.mark.parametrize("cell,mode,policy", PRECISION_CELLS)
def test_pruned_physical_equals_masked_unpruned_bitwise(detector, cell, mode, policy):
    """The physically pruned artifact and the masked full-size artifact give
    the same probabilities on the whole datapath, unsharded and sharded."""
    _, _, cfg, params = detector
    spec = plan_prune(params["conv1"]["w"], cfg.n_frames, keep=3, trim_frames=1)
    masked, frame_spec = _masked_setup(params, cfg, spec)
    pol = None if policy is None else PrecisionPolicy.parse(policy, default=mode)
    qp_pruned = quantize_params(params, cfg, mode=mode, prune=spec, policy=pol, device="cpu")
    qp_masked = quantize_params(masked, cfg, mode=mode, prune=frame_spec, policy=pol,
                                device="cpu")
    assert qp_pruned.pruned and qp_pruned.keep_frames == cfg.n_frames - 1
    x = _rows(np.random.default_rng(3), 8, cfg.input_len)
    p_pruned = tacc.accelerator_forward(qp_pruned, x, cfg, device="cpu").numpy()
    p_masked = tacc.accelerator_forward(qp_masked, x, cfg, device="cpu").numpy()
    assert _bits_equal(p_pruned, p_masked)
    assert _bits_equal(p_pruned, tacc.accelerator_forward_sharded(qp_masked, x, cfg, mesh=CPU4))


def test_permutation_across_shards_is_identity(detector):
    """Rows that change shard under a permutation unpermute to the
    unsharded result, bitwise, even with a 10^4 loudness spread."""
    _, _, tcfg, tp = detector
    rng = np.random.default_rng(11)
    x = _rows(rng, 8, tcfg.input_len)
    base = tacc.accelerator_forward(tp, x, tcfg, device="cpu").numpy()
    assert _bits_equal(base, tacc.accelerator_forward_sharded(tp, x, tcfg, mesh=CPU4).numpy())
    perm = rng.permutation(8)  # moves rows between the 4 entries
    got = tacc.accelerator_forward_sharded(tp, x[perm], tcfg, mesh=CPU4).numpy()
    assert _bits_equal(base, got[np.argsort(perm)])


def test_sharded_forward_checks_like_the_reference(detector):
    _, _, tcfg, tp = detector
    x = _rows(np.random.default_rng(2), 8, tcfg.input_len)
    with pytest.raises(ValueError, match="not divisible"):
        tacc.accelerator_forward_sharded(tp, x[:3], tcfg, mesh=CPU4)
    with pytest.raises(TypeError, match="per_sample_acts"):
        tacc.accelerator_forward_sharded(tp, x, tcfg, mesh=CPU4, per_sample_acts=False)
    # an fp32 checkpoint is baked on the first entry's device, fxp picks the mode
    qp = quantize_params(tp, tcfg, mode="fxp8", device="cpu")
    want = tacc.accelerator_forward(qp, x, tcfg, device="cpu").numpy()
    got = tacc.accelerator_forward_sharded(tp, x, tcfg, mesh=CPU4, fxp=True,
                                           axis_name=STREAM_AXIS)
    assert _bits_equal(want, got.numpy())


def test_stream_mesh_rejects_bad_shard_counts(monkeypatch):
    with pytest.raises(ValueError, match="local devices"):
        stream_mesh(0, device="cpu")
    mesh = stream_mesh(3, device="cpu")
    assert mesh.shape == {STREAM_AXIS: 3} and mesh.axis_names == (STREAM_AXIS,)
    assert mesh.devices == (torch.device("cpu"),) * 3
    # CUDA entries are the first k cards: more than the host has is refused
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="<= 2 local devices"):
        stream_mesh(3)
    with pytest.raises(ValueError, match="local devices"):
        stream_mesh(0)


def test_replicas_share_the_artifact_on_its_own_device(detector):
    """An entry on the artifact's device serves the artifact itself (K2's
    pack cache is keyed by tensor identity), so replication copies nothing."""
    _, _, tcfg, tp = detector
    qp = quantize_params(tp, tcfg, device="cpu")
    reps = replicate_params(qp, StreamMesh(("cpu",) * 4))
    assert len(reps) == 4 and all(r is qp for r in reps)


def test_engine_shards_and_mesh_checks(detector):
    """``shards=1`` routes through the sharded dispatch and equals the plain
    engine; a mesh that is not 1-D, disagrees with ``shards``, or does not
    divide ``batch_slots`` is refused; ``precompile`` warms the sharded
    ladder; adaptive slots keep multiples of the shard count."""
    _, _, tcfg, tp = detector
    kw = dict(n_streams=2, feature_kind="zcr", device="cpu")
    audio = _rows(np.random.default_rng(3), 2, 2 * features.N_SAMPLES)
    runs = []
    for extra in ({}, dict(shards=1, batch_slots=4), dict(mesh=CPU4, batch_slots=4)):
        eng = MonitorEngine(tp, tcfg, **kw, **extra)
        for s in range(2):
            eng.push(s, audio[s])
        runs.append([dataclasses.astuple(w) for w in eng.drain()])
    assert len(runs[0]) == 4 and runs[0] == runs[1] == runs[2]

    flat = types.SimpleNamespace(axis_names=("a", "b"), shape={"a": 2, "b": 2}, size=4,
                                 devices=(torch.device("cpu"),) * 4)
    with pytest.raises(ValueError, match="1-D mesh"):
        MonitorEngine(tp, tcfg, **kw, mesh=flat)
    with pytest.raises(ValueError, match="shards=2"):
        MonitorEngine(tp, tcfg, **kw, mesh=CPU4, shards=2)
    with pytest.raises(ValueError, match="divide evenly over 4 shards"):
        MonitorEngine(tp, tcfg, **kw, batch_slots=6, shards=4)

    eng = MonitorEngine(tp, tcfg, **kw, batch_slots=8, shards=4, adaptive_slots=True)
    assert eng.precompile() == (4, 8)
    assert eng.slot_policy.multiple == 4
