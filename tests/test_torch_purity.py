"""The port stands alone: no JAX, no ``repro``, no silent CPU fallback.

Every ``repro_torch`` module and ``chip_smoke.py`` import in a fresh
interpreter in which an import hook makes ``jax``, ``jaxlib`` and ``repro``
unimportable.  Entry points asked for the default device raise without a
GPU instead of dropping to the CPU.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "repro", "ml_dtypes")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert {"repro_torch.launch.train", "repro_torch.launch.mesh", "repro_torch.training.lm",
        "repro_torch.training.compression", "repro_torch.data.pipeline",
        "repro_torch.distributed.embedding", "repro_torch.launch.specs",
        "repro_torch.launch.dryrun", "repro_torch.launch.comm_analysis",
        "repro_torch.launch.roofline", "repro_torch.launch.hw",
        "repro_torch.core.sequential"} <= set(names)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 50  # every module walked


_DRYRUN_IMPORT = r"""
import importlib, importlib.abc, os, sys
BLOCKED = ("jax", "jaxlib", "repro", "ml_dtypes")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
env = dict(os.environ)
for name in ("repro_torch.launch.specs", "repro_torch.launch.dryrun",
             "repro_torch.launch.comm_analysis", "repro_torch.launch.roofline",
             "repro_torch.launch.hw", "repro_torch.core.sequential"):
    importlib.import_module(name)
import torch.distributed as dist
assert not dist.is_initialized(), "importing the dry run started a process group"
assert dict(os.environ) == env, "importing the dry run set an environment variable"
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("ok")
"""


def test_dry_run_imports_without_jax_repro_process_group_or_environment():
    proc = subprocess.run(
        [sys.executable, "-c", _DRYRUN_IMPORT], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_no_jax_or_repro_import_statements():
    pattern = re.compile(
        r"^\s*(import\s+(jax|repro|ml_dtypes)\b|from\s+(jax|repro|ml_dtypes)(\.|\s))", re.M)
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_raise_without_gpu_by_default(no_card, tmp_path):
    from repro_torch.distributed.sharding import stream_mesh
    from repro_torch.models import cnn1d
    from repro_torch.serving.accelerator import accelerator_forward
    from repro_torch.serving.engine import MonitorEngine
    from repro_torch.serving.quantized_params import (
        QuantizedParamsCache,
        load_artifact,
        quantize_params,
        save_artifact,
    )
    from repro_torch.serving.supervisor import FleetSupervisor

    cfg = cnn1d.CNNConfig(input_len=128, channels=(4, 8), hidden=8)
    params = cnn1d.init_params(cfg, torch.Generator().manual_seed(0))
    x = np.zeros((2, 128), np.float32)
    for call in (
        lambda: accelerator_forward(params, x, cfg),
        lambda: quantize_params(params, cfg),
        lambda: QuantizedParamsCache(params, cfg),
        lambda: MonitorEngine(params, cfg, n_streams=1, feature_kind="zcr"),
        lambda: stream_mesh(2),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    qp = quantize_params(params, cfg, device="cpu")
    save_artifact(tmp_path / "a.npz", qp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_artifact(tmp_path / "a.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accelerator_forward(qp, x, cfg)
    # the fleet, new or restored from a state dir, raises the same way
    for call in (
        lambda: FleetSupervisor(qp, cfg, n_streams=2, feature_kind="zcr"),
        lambda: FleetSupervisor.restore_from_dir(qp, cfg, state_dir=str(tmp_path / "none"),
                                                 feature_kind="zcr"),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert FleetSupervisor.restore_from_dir(
        qp, cfg, state_dir=str(tmp_path / "none"), feature_kind="zcr", device="cpu") is None
    # asked for the CPU, the same artifact serves
    assert accelerator_forward(qp, x, cfg, device="cpu").shape == (2, 2)


def test_lm_entry_points_raise_without_gpu_by_default(no_card):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    cfg = get_config("gemma-2b").smoke()
    params = T.init_params(0, cfg, device="cpu")
    for call in (
        lambda: T.init_params(0, cfg),
        lambda: serve.BatchedServer(cfg, params),
        lambda: serve.main(["--requests", "1"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for the CPU, the same params serve
    done = serve.BatchedServer(cfg, params, device="cpu").serve(
        [serve.Request(rid=0, prompt=np.arange(5, dtype=np.int32), max_new=2)])
    assert len(done[0].out) == 2


def test_lm_training_entry_points_raise_without_gpu_by_default(no_card):
    from repro_torch.data.pipeline import PrefetchingLoader
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh

    for call in (
        lambda: train.main(["--arch", "gemma-2b", "--smoke", "--steps", "1"]),
        lambda: make_host_mesh(),
        lambda: PrefetchingLoader(lambda step: None),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # asked for the CPU, each runs
    assert make_host_mesh(device="cpu").shape == {"data": 1, "model": 1}
    assert list(PrefetchingLoader(lambda step: None, device="cpu")) == []
