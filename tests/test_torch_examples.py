"""The examples on the port (``examples/torch_*.py``) on the CPU.

Each runs in a subprocess in which an import hook makes ``jax``,
``jaxlib`` and ``repro`` unimportable (as ``tests/test_torch_purity.py``
imports the port), all four at once, at the smallest arguments their own
asserts allow: the quickstart on 100 windows for one epoch (one batch of
64 to train on), the scene served by a detector of a 200-window corpus
trained for one epoch (cached in the test's directory), the LM trained its
60 steps (its loss must fall by a fifth: at 40 it does not), the precision
sweep as it is.  Their deterministic lines are held against the
reference's: the quickstart's prune (flatten 35,072 -> 8,704) and both
cycle-model latencies, the int8 weight fraction; and the precision sweep's
comparison (``compare``) on the JAX example's own params and tokens
(``PRNGKey(0)`` and ``PRNGKey(1)``, carried as numpy) against the JAX
example's top-1 agreement (equal) and mean TV distance (within
``TVD_ATOL``).
"""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

_BLOCKED_RUN = r"""
import importlib.abc, runpy, sys
BLOCKED = ("jax", "jaxlib", "repro", "ml_dtypes")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
"""



def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports the standard
    library only)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: example -> its arguments (the test's directory substituted for ``{tmp}``),
#: the ones ``chip_smoke.py`` runs them at on the card
ARGS = _chip_smoke().EXAMPLE_ARGS
#: the precision sweep's mean TV distance on the reference's params against
#: the reference's (measured: 1.7e-7 of 0.0141)
TVD_ATOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every example's stdout, the four run concurrently, and meanwhile the
    reference's numbers (``"reference"``)."""
    tmp = tmp_path_factory.mktemp("examples")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", _BLOCKED_RUN, str(EXAMPLES / name),
         *[a.format(tmp=tmp) for a in args], "--device", "cpu"],
        cwd=ROOT, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}) for name, args in ARGS.items()}
    out = {"tmp": tmp, "reference": _reference()}
    for name, proc in procs.items():
        stdout, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, err[-4000:])
        out[name] = stdout
    return out


def _reference() -> dict:
    """The reference's prune of its canonical model, its cycle-model
    latencies, and its precision sweep (:func:`_jax_sweep`)."""
    import jax

    from repro.core import timing_model as JTM
    from repro.models import cnn1d as JC

    _, _, spec = JC.prune_model(JC.init_params(jax.random.PRNGKey(0)), JC.CANONICAL)
    return {"prune": spec, "latency": {p: JTM.shield8_latency(pruned=p) for p in (False, True)},
            "sweep": _jax_sweep()}


def _line(stdout: str, start: str) -> str:
    (line,) = [ln.strip() for ln in stdout.splitlines() if ln.strip().startswith(start)]
    return line


def test_quickstart_prune_and_latencies_are_the_reference_lines(runs):
    spec = runs["reference"]["prune"]
    assert (spec.flatten_before, spec.flatten_after) == (35072, 8704)
    out = runs["torch_quickstart.py"]
    want = f"flatten {spec.flatten_before} -> {spec.flatten_after} ({spec.reduction*100:.1f}%)"
    assert _line(out, "flatten").startswith(want + ", acc=")
    for pruned in (False, True):
        lat = runs["reference"]["latency"][pruned]
        name = "pruned" if pruned else "unpruned"
        assert _line(out, name + ":") == (f"{name}: {lat['seconds']*1e3:.1f} ms @100MHz "
                                          "(paper deployed: 116 ms)")
    for prec in ("fp32", "bf16", "int8", "fxp8"):
        assert _line(out, prec).startswith(f"{prec:5s}: acc=")


def test_serve_acoustic_streams_the_scene_and_reports_events(runs):
    """The header, a row every fifth window of the scene's 75 (and every
    tracked one), and the events' summary."""
    out = runs["torch_serve_acoustic.py"]
    lines = out.splitlines()
    assert lines[0] == "t(s)  p_uav  ema    state"
    times = [float(ln.split()[0]) for ln in lines[1:] if re.match(r"^ *\d+\.\d  \d\.\d\d  ", ln)]
    assert {round(i * 0.8, 1) for i in range(0, 75, 5)} <= set(times)
    assert "event(s); ground truth: one UAV pass at 20.0-38.0s" in out
    assert (runs["tmp"] / "detector" / "model_mfcc20").is_dir()


def test_train_lm_loss_falls_and_checkpoints(runs):
    out = runs["torch_train_lm.py"]
    assert _line(out, "OK: loss fell")
    steps = sorted(p.name for p in (runs["tmp"] / "ckpt" / "olmoe-1b-7b").iterdir())
    assert "step_0000000050" in steps, steps  # every 25 steps


def _jax_sweep():
    """The JAX example's computation (``examples/precision_sweep_lm.py``):
    its params and tokens, its fraction, agreement and TV distance."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import quantized as JQ
    from repro.models import transformer as JT

    cfg = get_config("gemma-2b").smoke()
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (2, 64), 0, cfg.vocab)}
    base = JT.forward(params, batch, cfg)
    qparams = JQ.quantize_lm_params(params, JQ.default_lm_policy(cfg))
    quant = JT.forward(qparams, batch, cfg)
    base_p, quant_p = jax.nn.softmax(base, axis=-1), jax.nn.softmax(quant, axis=-1)
    return params, batch["tokens"], {
        "fraction": JQ.quantized_fraction(qparams),
        "agree": float(jnp.mean(jnp.argmax(base, -1) == jnp.argmax(quant, -1))),
        "tvd": float(0.5 * jnp.abs(base_p - quant_p).sum(-1).mean())}


def test_precision_sweep_matches_the_reference_on_its_params(runs):
    """The port's example prints the reference's int8 weight fraction, and
    its ``compare`` on the JAX example's params and tokens gives the JAX
    example's agreement and (within ``TVD_ATOL``) its TV distance."""
    import jax

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT

    params, tokens, want = runs["reference"]["sweep"]
    assert _line(runs["torch_precision_sweep_lm.py"], "quantised int8 weight fraction") == (
        f"quantised int8 weight fraction : {want['fraction']*100:.1f}% of parameter elements")
    spec = importlib.util.spec_from_file_location("torch_precision_sweep_lm",
                                                  EXAMPLES / "torch_precision_sweep_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = get_config("gemma-2b").smoke()
    carried = TT.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), cfg)
    got = mod.compare(carried, torch.from_numpy(np.array(tokens, np.int32)), cfg)
    assert got["fraction"] == want["fraction"]
    assert got["agree"] == want["agree"]
    assert abs(got["tvd"] - want["tvd"]) <= TVD_ATOL, (got, want)


@pytest.mark.parametrize("name", list(ARGS))
def test_example_asks_for_the_gpu_by_default(name, tmp_path, monkeypatch):
    """Without ``--device`` an example runs on the GPU, and without one it
    raises before any work (it never drops to the CPU on its own)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    monkeypatch.chdir(tmp_path)  # whatever a default would write lands here
    spec = importlib.util.spec_from_file_location(name[:-3], EXAMPLES / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
    assert not any(tmp_path.iterdir())
