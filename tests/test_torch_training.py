"""Detector training and analysis of the port against the JAX reference.

The same seeded numpy inputs and the reference's params (``params_from_numpy``
of a ``jax.random`` init) go through both packages, at small widths
(``channels=(4, 8)``, ``hidden=8``); the emulation forward and its
gradients are held in ``tests/test_torch_emulation_forward.py``.
Tolerances, and why:

* ``calibrate_alphas``: rtol 1e-5 (its percentile is bitwise given equal
  activations; the activations come from another conv);
* Adam, the schedule and training steps: rtol 1e-5 (XLA fuses and
  contracts the jitted update);
* ``deviation_report``: 1e-6 on the deviation, decisions equal;
* the corpus, the percentile, checkpoints, the baked artifact and the
  timing model: bitwise or exact.

Training itself cannot match bit for bit (``jax.random`` has no PyTorch
counterpart): it is held by accuracy, and its own determinism by bits.
"""
import json
import os
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import timing_model as jtm  # noqa: E402
from repro.data import acoustic as jacoustic  # noqa: E402
from repro.models import cnn1d as jcnn  # noqa: E402
from repro.serving import accelerator as jacc  # noqa: E402
from repro.serving import quantized_params as jqp  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import loop as jloop  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.core import timing_model as ttm  # noqa: E402
from repro_torch.core.quantization import QTensor  # noqa: E402
from repro_torch.data import acoustic as tacoustic  # noqa: E402
from repro_torch.models import cnn1d as tcnn  # noqa: E402
from repro_torch.serving import accelerator as tacc  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import detector_artifact as tdet  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402

torch.set_num_threads(1)

GRAD_RTOL = 1e-5
SMALL = dict(input_len=128, channels=(4, 8), hidden=8)


def _setup(seed, rows=16, calibrate=True, **cfg_kw):
    kw = {**SMALL, **cfg_kw}
    jcfg, tcfg = jcnn.CNNConfig(**kw), tcnn.CNNConfig(**kw)
    jp = jcnn.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, kw["input_len"])).astype(np.float32)
    y = rng.integers(0, 2, rows).astype(np.int32)
    if calibrate:  # realistic clips: the 8-bit modes then clip and tie
        jp = jcnn.calibrate_alphas(jp, jnp.asarray(x), jcfg)
    tp = tcnn.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp, x, y


def test_calibrate_alphas_matches_reference():
    jcfg, tcfg, jp, tp, x, _ = _setup(6, rows=32, calibrate=False)
    want = jcnn.calibrate_alphas(jp, jnp.asarray(x), jcfg)
    got = tcnn.calibrate_alphas(tp, torch.from_numpy(x), tcfg)
    for layer in ("conv0", "conv1", "dense0"):
        np.testing.assert_allclose(float(got[layer]["alpha"]), float(want[layer]["alpha"]),
                                   rtol=1e-5)
        assert got[layer]["alpha"].shape == ()
    assert "alpha" not in got["dense1"] and got["conv0"]["w"] is tp["conv0"]["w"]
    assert float(tp["conv0"]["alpha"]) == 6.0  # the input params are left alone


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 12345, (1 << 24) + 1_179_648])
def test_percentile_has_jnp_percentile_bits(n):
    """``percentile`` against ``jnp.percentile`` bitwise, past the 2**24
    values ``torch.quantile`` refuses (the last size is 256 canonical conv0
    rows: 256 x 1,096 x 64 = 17,956,864, where ``float32(n) - 1`` rounds)."""
    a = np.random.default_rng(n % 97).standard_normal(n).astype(np.float32)
    pcts = (99.9, 50.0, 0.0, 100.0, 12.5, 33.3)
    if n > 1 << 24:  # the calibration's percentile; sorted input is still
        a.sort()  # input, and XLA's sort of it is quicker
        pcts = (99.9,)
    for pct in pcts:
        got = tcnn.percentile(torch.from_numpy(a), pct)
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.numpy().tobytes() == np.asarray(jnp.percentile(jnp.asarray(a), pct)).tobytes()


def test_adam_three_steps_and_global_norm_match_reference():
    _, _, jp, tp, _, _ = _setup(7, calibrate=False)
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda v: rng.standard_normal(np.shape(v)).astype(np.float32) * 0.3, jp)
             for _ in range(3)]
    for kw in ({}, {"grad_clip_norm": None, "weight_decay": 0.01},
               {"lr": "schedule", "grad_clip_norm": 100.0}):
        jkw, tkw = dict(kw), dict(kw)
        if kw.get("lr") == "schedule":
            jkw["lr"] = jopt.cosine_warmup_schedule(1e-2, 2, 10)
            tkw["lr"] = topt.cosine_warmup_schedule(1e-2, 2, 10)
        jo, to = jopt.Adam(**jkw), topt.Adam(**tkw)
        js_, ts_ = jo.init(jp), to.init(tp)
        jparams, tparams = jp, tp
        for g in grads:
            np.testing.assert_allclose(float(topt.global_norm(tcnn.params_from_numpy(g))),
                                       float(jopt.global_norm(g)), rtol=GRAD_RTOL)
            jparams, js_ = jo.update(g, js_, jparams)
            tparams, ts_ = to.update(tcnn.params_from_numpy(g), ts_, tparams)
        assert int(ts_.step) == int(js_.step) == 3 and ts_.step.dtype == torch.int32
        for tree_t, tree_j in ((tparams, jparams), (ts_.mu, js_.mu), (ts_.nu, js_.nu)):
            for layer, leaves in tree_j.items():
                for k, v in leaves.items():
                    np.testing.assert_allclose(tree_t[layer][k].numpy(), np.asarray(v),
                                               rtol=GRAD_RTOL, atol=1e-9)


def test_cosine_warmup_schedule_matches_reference():
    jlr = jopt.cosine_warmup_schedule(3e-3, 5, 40, floor=0.2)
    tlr = topt.cosine_warmup_schedule(3e-3, 5, 40, floor=0.2)
    for step in [0, 1, 4, 5, 6, 17, 39, 40, 41, 100]:
        got = tlr(torch.tensor(step, dtype=torch.int32))
        want = jlr(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-12)


def test_train_step_without_dropout_matches_jitted_reference():
    """One jitted reference step and the port's step from the same params
    and batch, dropout off (its masks cannot match): loss, new params and
    Adam moments within rtol."""
    jcfg, tcfg, jp, tp, x, y = _setup(8, rows=32, calibrate=False, dropout=0.0)
    jparams, jstate = jp, jloop._OPT.init(jp)
    tparams, tstate = tp, tloop.OPT.init(tp)
    for i in range(3):
        xb, yb = x[i * 8: (i + 1) * 8], y[i * 8: (i + 1) * 8]
        jparams, jstate, jl = jloop._train_step(jparams, jstate, jnp.asarray(xb),
                                                jnp.asarray(yb), None, jcfg)
        tparams, tstate, tl = tloop.train_step(tparams, tstate, torch.from_numpy(xb),
                                               torch.from_numpy(yb), None, tcfg)
        np.testing.assert_allclose(float(tl), float(jl), rtol=GRAD_RTOL)
    for layer, leaves in jparams.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(tparams[layer][k].numpy(), np.asarray(v),
                                       rtol=GRAD_RTOL, atol=1e-7, err_msg=f"{layer}/{k}")


@pytest.mark.parametrize("n,seed", [(6, 0), (9, 7)])
def test_make_dataset_bitwise(n, seed):
    for kw in ({}, {"snr_range": (-12.0, 18.0), "p_clean": 0.08}):
        want = jacoustic.make_dataset(n, seed=seed, **kw)
        got = tacoustic.make_dataset(n, seed=seed, **kw)
        for field in ("audio", "labels", "snr_db"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_make_snr_sweep_bitwise():
    want = jacoustic.make_snr_sweep(4, [-5.0, 0.0, 10.0], seed=3)
    got = tacoustic.make_snr_sweep(4, [-5.0, 0.0, 10.0], seed=3)
    assert list(got) == list(want)
    for snr in want:
        for a, b in zip(got[snr], want[snr]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _trees(seed=0):
    _, _, jp, tp, _, _ = _setup(seed, calibrate=False)
    jstate = jopt.Adam().init(jp)
    tstate = topt.Adam().init(tp)
    return {"params": jp, "opt": jstate}, {"params": tp, "opt": tstate}


def test_checkpoint_written_by_reference_restores_in_port(tmp_path):
    jtree, ttree = _trees(1)
    path = jckpt.save_checkpoint(tmp_path, 7, jtree, extra={"who": "jax"})
    step, got = tckpt.restore_checkpoint(path, ttree, device="cpu")
    assert step == 7 and isinstance(got["opt"], topt.AdamState)
    assert got["opt"].step.dtype == torch.int32
    for (kj, vj), (kt, vt) in zip(jckpt._flatten_with_paths(jtree),
                                  tckpt._flatten_with_paths(got)):
        assert kj == kt and np.asarray(vj).tobytes() == vt.numpy().tobytes()


def test_checkpoint_written_by_port_restores_in_reference(tmp_path):
    jtree, ttree = _trees(2)
    path = tckpt.save_checkpoint(tmp_path, 3, ttree)
    manifest = json.loads((path / "MANIFEST.json").read_text())
    assert [e["key"] for e in manifest["leaves"]] == [k for k, _ in jckpt._flatten_with_paths(jtree)]
    assert sorted(os.listdir(path)) == ["MANIFEST.json"] + [f"leaf_{i:05d}.npy" for i in range(
        len(manifest["leaves"]))]
    step, got = jckpt.restore_checkpoint(path, jtree)
    assert step == 3
    want = tcnn.params_to_numpy(ttree["params"])
    assert jax.tree.map(lambda a: np.asarray(a).tobytes(), got["params"]) == \
        jax.tree.map(lambda a: a.tobytes(), want)
    back = tcnn.params_from_numpy(want)
    assert all(torch.equal(back[k][n], ttree["params"][k][n]) for k in back for n in back[k])
    for (kt, vt), (kj, vj) in zip(tckpt._flatten_with_paths(ttree), jckpt._flatten_with_paths(got)):
        assert kt == kj and vt.numpy().tobytes() == np.asarray(vj).tobytes()
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(path, {"params": {**ttree["params"], "dense1": {
            "w": torch.zeros(3, 3), "b": torch.zeros(2)}}, "opt": ttree["opt"]}, device="cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.restore_checkpoint(path, {"extra": torch.zeros(1)}, device="cpu")


def test_checkpoint_manager_retention_and_atomic_publish(tmp_path, monkeypatch):
    _, ttree = _trees(3)
    mgr = tckpt.CheckpointManager(tmp_path, keep=2, save_every=5)
    assert mgr.maybe_restore(ttree, device="cpu") == (0, ttree)
    assert [mgr.should_save(s) for s in (0, 4, 5, 10)] == [False, False, True, True]
    for step in (5, 10, 15):
        mgr.save(step, ttree)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000000010", "step_0000000015"]
    assert tckpt.latest_checkpoint(tmp_path).name == "step_0000000015"
    step, _ = mgr.maybe_restore(ttree, device="cpu")
    assert step == 15

    # a save that dies mid-way publishes nothing and leaves no temp dir
    calls = {"n": 0}
    real_save = np.save

    def dying_save(path, arr):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("disk full")
        real_save(path, arr)

    monkeypatch.setattr(tckpt.np, "save", dying_save)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(20, ttree)
    monkeypatch.setattr(tckpt.np, "save", real_save)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000000010", "step_0000000015"]
    # the reference's manager reads what the port's wrote
    step, _ = jckpt.CheckpointManager(tmp_path).maybe_restore(_trees(3)[0])
    assert step == 15


TIMING_CASES = [
    ("eq10_closed_form", lambda tm, macs: tm.total_cycles_sequential(
        {"l1": 40, "l2": 80, "l3": 120}, 0, tm.DatapathConfig(mac_bank_width=4, piso=False))),
    ("piso", lambda tm, macs: tm.total_cycles_sequential({"l1": 4}, 1000)),
    ("parallel", lambda tm, macs: tm.total_cycles_parallel(macs(tm))),
    ("sequential", lambda tm, macs: tm.total_cycles_sequential(macs(tm), 35072)),
    ("latency_pruned", lambda tm, macs: tm.shield8_latency(pruned=True)),
    ("latency_unpruned", lambda tm, macs: tm.shield8_latency(pruned=False)),
    ("resources_w4", lambda tm, macs: tm.resource_estimate()),
    ("resources_w8", lambda tm, macs: tm.resource_estimate(tm.DatapathConfig(mac_bank_width=8))),
    ("width_2", lambda tm, macs: tm.total_cycles_sequential(
        {"l": 1000}, 0, tm.DatapathConfig(mac_bank_width=2))),
    ("energy", lambda tm, macs: tm.energy_joules(0.116, 0.94)),
]


@pytest.mark.parametrize("name,case", TIMING_CASES, ids=[c[0] for c in TIMING_CASES])
def test_timing_model_matches_reference(name, case):
    def j_macs(tm):
        return jcnn.layer_macs(jcnn.CANONICAL)

    def t_macs(tm):
        return tcnn.layer_macs(tcnn.CANONICAL)

    assert case(ttm, t_macs) == case(jtm, j_macs)


def test_timing_model_calibration_and_layer_macs():
    assert abs(ttm.shield8_latency(pruned=True)["seconds"] * 1e3 - 116.0) < 1.0
    for pruned in (None, 8_704):
        assert tcnn.layer_macs(tcnn.CANONICAL, pruned) == jcnn.layer_macs(jcnn.CANONICAL, pruned)
    r = ttm.resource_estimate()
    assert (r["luts"], r["ffs"], r["bram_dsp"]) == (2268, 3250, 8)
    jcfg, tcfg, jp, tp, _, _ = _setup(0, calibrate=False)
    assert tcnn.count_params(tp) == jcnn.count_params(jp)


@pytest.mark.parametrize("per_sample", [True, False])
def test_deviation_report_matches_reference(per_sample):
    jcfg, tcfg, jp, tp, x, _ = _setup(10, rows=8)
    x[0] *= 100.0  # one loud row: per-tensor activation scales then differ
    want = jacc.deviation_report(jp, jnp.asarray(x), jcfg, per_sample_acts=per_sample)
    got = tacc.deviation_report(tp, x, tcfg, per_sample_acts=per_sample, device="cpu")
    assert got["decision_agreement"] == want["decision_agreement"]
    np.testing.assert_allclose(got["max_prob_dev"], want["max_prob_dev"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["int8", "fxp8"])
def test_export_quantized_equals_reference_bake(mode):
    jcfg, tcfg, jp, tp, _, _ = _setup(11)
    want = jcnn.export_quantized(jp, jcfg, mode=mode)
    got = tcnn.export_quantized(tp, tcfg, mode=mode, device="cpu")
    assert got.mode == want.mode and got.layer_modes == (want.conv_modes, want.dense_modes)
    for tl, jl in zip((*got.convs, *got.denses), (*want.convs, *want.denses)):
        assert isinstance(tl["w"], QTensor)
        for a, b in ((tl["w"].q, jl["w"].q), (tl["w"].scale, jl["w"].scale), (tl["b"], jl["b"])):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype and a.numpy().tobytes() == b.tobytes()
    assert isinstance(want, jqp.QuantizedParams)


def test_detector_learns_separable_task():
    rng = np.random.default_rng(0)
    n, m = 384, 128
    x = rng.standard_normal((n, m)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.int32)
    x[y == 1, :16] += 4.0  # strong localized pattern
    cfg = tcnn.CNNConfig(input_len=m, channels=(4, 8), hidden=8, dropout=0.1)
    res = tloop.train_detector(x[:288], y[:288], x[288:], y[288:], cfg, epochs=25, batch=32,
                               patience=25, device="cpu")
    assert res.best_val_acc > 0.85
    assert all(t.device.type == "cpu" for leaves in res.params.values() for t in leaves.values())


def test_seeded_cpu_training_is_deterministic():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((96, 128)).astype(np.float32)
    y = rng.integers(0, 2, 96).astype(np.int32)
    cfg = tcnn.CNNConfig(**SMALL)
    runs = [tloop.train_detector(x[:64], y[:64], x[64:], y[64:], cfg, epochs=3, batch=16,
                                 seed=4, device="cpu") for _ in range(2)]
    other = tloop.train_detector(x[:64], y[:64], x[64:], y[64:], cfg, epochs=3, batch=16,
                                 seed=5, device="cpu")
    assert runs[0].history == runs[1].history and len(runs[0].history) == 3
    for layer, leaves in runs[0].params.items():
        for k, v in leaves.items():
            assert v.numpy().tobytes() == runs[1].params[layer][k].numpy().tobytes()
    assert not torch.equal(other.params["conv0"]["w"], runs[0].params["conv0"]["w"])


def test_get_detector_trains_caches_and_reloads(tmp_path, monkeypatch):
    """The cached-detector path at a tiny corpus: the first call trains and
    caches (corpus, features, checkpoint), the second restores the same
    params; the sensitivity policy pins the head at FP32."""
    monkeypatch.setattr(tdet, "ARTIFACTS", tmp_path)
    monkeypatch.setattr(tdet, "DATASET", dict(n=96, seed=7, snr_range=(-12.0, 18.0), p_clean=0.08))
    monkeypatch.setattr(tdet, "SPLIT", (72, 12))  # one step of 64 an epoch
    det = tdet.get_detector("zcr", epochs=2, device="cpu")
    assert {p.name for p in tmp_path.iterdir()} == {"dataset.npz", "feats_zcr.npy", "model_zcr"}
    want = jacoustic.make_dataset(**tdet.DATASET)
    assert det["labels"].tobytes() == want.labels.tobytes()
    assert det["cfg"].input_len == 128 and det["cfg"].channels == (64, 128, 256)
    again = tdet.get_detector("zcr", device="cpu")
    for layer, leaves in det["params"].items():
        for k, v in leaves.items():
            assert torch.equal(v, again["params"][layer][k])
    assert 0.0 <= det["metrics"].accuracy <= 1.0
    pol = tdet.sensitivity_policy(det, n_batch=16)
    assert pol.default.value == "int8" and pol.rules["dense1/w"].value == "fp32"
    assert set(pol.rules) == {"conv0/w", "conv1/w", "conv2/w", "dense0/w", "dense1/w"}
    assert sum(v.value == "bf16" for v in pol.rules.values()) <= 1


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_training_entry_points_raise_without_gpu_by_default(no_card, tmp_path):
    cfg = tcnn.CNNConfig(**SMALL)
    x = np.zeros((4, 128), np.float32)
    y = np.zeros(4, np.int32)
    path = tckpt.save_checkpoint(tmp_path, 1, {"a": torch.zeros(2)})
    params = tcnn.init_params(cfg, torch.Generator().manual_seed(0))
    for call in (
        lambda: tloop.train_detector(x, y, x, y, cfg, epochs=1),
        lambda: tdet.get_detector("zcr"),
        lambda: tckpt.restore_checkpoint(path, {"a": torch.zeros(2)}),
        lambda: tcnn.export_quantized(params, cfg),
        lambda: tacc.deviation_report(params, x, cfg),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_artifacts_dir_is_the_ports_own():
    assert tdet.ARTIFACTS == Path(__file__).resolve().parents[1] / "artifacts" / "detector_torch"
    assert tdet.DATASET == dict(n=2400, seed=7, snr_range=(-12.0, 18.0), p_clean=0.08)
    assert tdet.SPLIT == (1800, 300)
