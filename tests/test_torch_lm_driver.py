"""The port's LM training driver, loader and checkpoints.

* ``PrefetchingLoader``: the twins of ``tests/test_pipeline_loader.py`` and
  of ``test_sharding_distributed.py::test_prefetch_loader``, on the CPU;
* ``python -m repro_torch.launch.train``: runs, exits 75 under a forced
  straggler after checkpointing, resumes to the uninterrupted run's bits,
  and writes an emergency checkpoint on SIGTERM;
* checkpoints: an fp32 LM checkpoint (params + ``AdamState``) crosses
  between the packages both ways and the next step matches; bf16 leaves
  are written with JAX's bytes and manifest entry, read back bitwise, and a
  JAX-written bf16 checkpoint restores into the port bitwise (the
  reference itself cannot read it back).
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import checkpoint as JCK  # noqa: E402
from repro.training import lm as JLM  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.data.pipeline import PrefetchingLoader, synthetic_lm_batches  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import checkpoint as TCK  # noqa: E402
from repro_torch.training import lm as TLM  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------


def _batch(step: int) -> dict:
    return {"x": np.full(4, step, np.float32)}


def test_close_returns_promptly_with_full_queue():
    ld = PrefetchingLoader(_batch, prefetch=2, device="cpu")
    deadline = time.time() + 5.0
    while ld._q.qsize() < 2 and time.time() < deadline:
        time.sleep(0.01)  # let the prefetch queue fill; worker now blocks
    t0 = time.perf_counter()
    ld.close()
    assert time.perf_counter() - t0 < 2.0
    assert not ld._thread.is_alive()


def test_close_idempotent_and_iter_terminates_after_close():
    ld = PrefetchingLoader(_batch, prefetch=1, device="cpu")
    time.sleep(0.05)
    ld.close()
    ld.close()
    assert list(ld) == []  # sentinel left behind ends any late consumer


def test_finite_stream_yields_all_batches_then_ends():
    n = 5
    ld = PrefetchingLoader(lambda s: _batch(s) if s < n else None, prefetch=2, device="cpu")
    got = [int(b["x"][0]) for b in ld]
    assert got == list(range(n))
    ld.close()
    assert not ld._thread.is_alive()


def test_batches_arrive_in_order_while_consuming():
    ld = PrefetchingLoader(_batch, prefetch=3, device="cpu")
    it = iter(ld)
    got = [int(next(it)["x"][0]) for _ in range(10)]
    assert got == list(range(10))
    ld.close()
    assert not ld._thread.is_alive()


def test_prefetch_loader():
    make = synthetic_lm_batches(vocab=64, batch=2, seq=8, n_steps=3)
    batches = list(PrefetchingLoader(make, prefetch=2, device="cpu"))
    assert len(batches) == 3
    assert batches[0]["tokens"].shape == (2, 8)
    assert isinstance(batches[0]["tokens"], torch.Tensor)
    assert batches[0]["tokens"].device.type == "cpu"
    make2 = synthetic_lm_batches(vocab=64, batch=2, seq=8, n_steps=3)
    b2 = list(PrefetchingLoader(make2, prefetch=1, device="cpu"))
    assert torch.equal(batches[1]["tokens"], b2[1]["tokens"])


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

ARGS = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--steps", "8", "--batch", "4",
        "--seq", "16", "--n-micro", "2", "--log-every", "1"]


@pytest.fixture
def keep_sigterm():
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


def _final(ckpt_dir: Path, step: int):
    path = ckpt_dir / "gemma-2b" / f"step_{step:010d}"
    manifest = json.loads((path / "MANIFEST.json").read_text())
    return manifest, {e["key"]: np.load(path / e["file"]) for e in manifest["leaves"]}


def test_driver_straggler_exit_then_resume_equals_uninterrupted(tmp_path, keep_sigterm, capsys):
    """Uninterrupted 8 steps, against: a forced straggler (every step past
    the sixth counts) checkpoints step 7 and exits 75, then a plain rerun
    resumes from it, takes the 8th step's batch and ends on the
    uninterrupted run's bits."""
    full = train.main(ARGS + ["--ckpt-dir", str(tmp_path / "a")])
    assert len(full) == 8 and all(np.isfinite(full))
    out = capsys.readouterr().out
    assert "arch=gemma-2b" in out and "step 0: loss=" in out and "done: 8 steps" in out
    with pytest.raises(SystemExit) as exc:
        train.main(ARGS + ["--ckpt-dir", str(tmp_path / "b"), "--straggler-factor", "0",
                           "--max-straggler-steps", "1"])
    assert exc.value.code == 75
    assert "[straggler] persistent skew" in capsys.readouterr().out
    manifest, _ = _final(tmp_path / "b", 7)
    assert manifest["extra"] == {"straggler_exit": True}
    rest = train.main(ARGS + ["--ckpt-dir", str(tmp_path / "b")])
    assert rest == full[7:]
    ma, a = _final(tmp_path / "a", 8)
    mb, b = _final(tmp_path / "b", 8)
    assert [e["key"] for e in ma["leaves"]] == [e["key"] for e in mb["leaves"]]
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_driver_writes_emergency_checkpoint_on_sigterm(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS[:5], "--steps", "100000",
         "--batch", "2", "--seq", "8", "--log-every", "1", "--ckpt-dir", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    try:
        for line in proc.stdout:
            if line.startswith("step 2:"):
                break
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 143, proc.stderr.read()[-2000:]
    latest = TCK.latest_checkpoint(tmp_path / "gemma-2b")
    manifest = json.loads((latest / "MANIFEST.json").read_text())
    assert manifest["extra"] == {"emergency": True} and manifest["step"] >= 3
    tcfg = tget_config("gemma-2b").smoke()
    params = TT.init_params(0, tcfg, device="cpu")
    step, (p, o) = TCK.restore_checkpoint(latest, (params, TO.Adam().init(params)),
                                          device="cpu")
    assert step == manifest["step"] == int(o.step)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def _to_jax(np_tree, cfg):
    specs = JT.build_specs(cfg)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        return jnp.asarray(t, jnp.dtype(s.dtype or cfg.param_dtype))

    return walk(np_tree, specs)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(tree[k]) for k in sorted(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _batch_lm(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (4, 12)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def test_fp32_lm_checkpoint_crosses_both_ways_and_next_step_matches(tmp_path):
    jcfg, tcfg = jget_config("gemma-2b").smoke(), tget_config("gemma-2b").smoke()
    npp = TT.params_to_numpy(TT.init_params(0, tcfg, device="cpu"))
    topt = TO.Adam(lr=1e-3, eps=1e-3, grad_clip_norm=None)
    jopt = JO.Adam(lr=1e-3, eps=1e-3, grad_clip_norm=None)
    tstep = TLM.make_train_step(tcfg, topt, TLM.TrainSettings(n_micro=2))
    jstep = jax.jit(JLM.make_train_step(jcfg, jopt, JLM.TrainSettings(n_micro=2)))
    b1, b2 = _batch_lm(tcfg, 1), _batch_lm(tcfg, 2)
    tb = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}  # noqa: E731
    jb = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731

    # port -> JAX
    tp = TT.params_from_numpy(npp, tcfg)
    tp, to, _ = tstep(tp, topt.init(tp), tb(b1))
    TCK.save_checkpoint(tmp_path / "port", 1, (tp, to))
    jp0 = _to_jax(npp, jcfg)
    step, (jp, jo) = JCK.restore_checkpoint(JCK.latest_checkpoint(tmp_path / "port"),
                                            (jp0, jopt.init(jp0)))
    assert step == 1 and int(jo.step) == 1
    for (ka, a), (_, b) in zip(_flat(_np((tp, to)[0])), _flat(_np(jp))):
        assert a.tobytes() == np.asarray(b).tobytes(), ka
    # JAX -> port
    jp2, jo2, jm = jstep(jp, jo, jb(b2))
    JCK.save_checkpoint(tmp_path / "jax", 2, (jp2, jo2))
    tp_like = TT.params_from_numpy(npp, tcfg)
    step, (rp, ro) = TCK.restore_checkpoint(TCK.latest_checkpoint(tmp_path / "jax"),
                                            (tp_like, topt.init(tp_like)), device="cpu")
    assert step == 2 and int(ro.step) == 2 and ro.step.dtype == torch.int32
    assert ro.step.shape == ()  # a scalar stays a scalar
    for tree_t, tree_j in ((rp, jp2), (ro.mu, jo2.mu), (ro.nu, jo2.nu)):
        for (ka, a), (_, b) in zip(_flat(_np(tree_t)), _flat(_np(tree_j))):
            assert a.tobytes() == np.asarray(b).tobytes(), ka
    # the port's own second step from its restored first one matches JAX's
    _, (tp1, to1) = TCK.restore_checkpoint(TCK.latest_checkpoint(tmp_path / "port"),
                                           (tp_like, topt.init(tp_like)), device="cpu")
    tp2, _, tm = tstep(tp1, to1, tb(b2))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-6 * abs(float(jm["loss"]))
    for (ka, a), (_, b) in zip(_flat(_np(tp2)), _flat(_np(jp2))):
        assert float(np.abs(a - np.asarray(b)).max()) <= 2e-5, ka


@pytest.fixture(scope="module")
def bf16_tree():
    """gemma-2b's smoke params in bf16 (its published dtype), from the
    port's draw; the same values as JAX arrays."""
    cfg = tget_config("gemma-2b").smoke().replace(param_dtype="bfloat16")
    tp = TT.init_params(0, cfg, device="cpu")
    jcfg = jget_config("gemma-2b").smoke().replace(param_dtype="bfloat16")
    jp = _to_jax(TT.params_to_numpy(tp), jcfg)
    return tp, jp


def test_jax_written_bf16_checkpoint_restores_into_port_bitwise(tmp_path, bf16_tree):
    tp, jp = bf16_tree
    assert jp["embed"]["tok"].dtype == jnp.bfloat16
    path = JCK.save_checkpoint(tmp_path, 3, jp)
    like = {k: v for k, v in tp.items()}
    step, got = TCK.restore_checkpoint(path, like, device="cpu")
    assert step == 3
    for (k, a), (_, b) in zip(_flat(got), _flat(jp)):
        assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16 else torch.float32), k
        assert a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32).numpy(
        ).tobytes() == np.asarray(b).tobytes(), k


def test_reference_cannot_restore_its_own_bf16_checkpoint(tmp_path, bf16_tree):
    """The reference's quirk (ROADMAP guard list): it writes bf16 leaves it
    cannot read back (``jnp.asarray`` of the void array)."""
    _, jp = bf16_tree
    path = JCK.save_checkpoint(tmp_path, 1, jp)
    with pytest.raises(Exception):
        JCK.restore_checkpoint(path, jp)


def test_port_bf16_leaf_has_jax_bytes_and_manifest_entry(tmp_path, bf16_tree):
    tp, jp = bf16_tree
    pj = JCK.save_checkpoint(tmp_path / "jax", 1, jp)
    pt = TCK.save_checkpoint(tmp_path / "port", 1, tp)
    mj = json.loads((pj / "MANIFEST.json").read_text())["leaves"]
    mt = json.loads((pt / "MANIFEST.json").read_text())["leaves"]
    assert mt == mj
    assert any(e["dtype"] == "bfloat16" for e in mt)
    for e in mt:
        a, b = np.load(pt / e["file"]), np.load(pj / e["file"])
        assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
        assert a.tobytes() == b.tobytes(), e["key"]


def test_port_bf16_checkpoint_round_trips_bitwise(tmp_path, bf16_tree):
    tp, _ = bf16_tree
    opt = TO.Adam()
    state = (tp, opt.init(tp))
    path = TCK.save_checkpoint(tmp_path, 5, state)
    step, (p, o) = TCK.restore_checkpoint(path, state, device="cpu")
    assert step == 5
    for (k, a), (_, b) in zip(_flat(p), _flat(tp)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                                                  else a, b.view(torch.int16)
                                                  if b.dtype == torch.bfloat16 else b), k
    assert o.step.dtype == torch.int32 and o.step.shape == () and int(o.step) == 0
