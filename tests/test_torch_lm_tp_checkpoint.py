"""Elastic checkpoints of tensor-parallel state (the twin of the reference's
``tests/test_sharding_distributed.py::test_elastic_restore_new_sharding``).

A checkpoint holds whole leaves in the reference's layout whatever mesh
wrote it: the ranks gather each cut leaf and rank 0 writes.  A restore
checks each leaf against its global shape and places this rank's part.
The ranks are ``gloo`` processes on ("data", "model") meshes of the
world's 4 (or 2) ranks; olmoe-1b-7b's smoke config (experts, vocab, heads
and kv heads cut at 2) after one train step, with its Adam state.

* saved at (2, 2), restored at (2, 2), (1, 4), (4, 1) and on 1 rank:
  every leaf's bits back;
* a checkpoint the JAX package writes restores onto a port (2, 2) mesh, and
  one the port writes restores into the reference with ``shardings=`` on a
  (2, 2) mesh of 4 forced host devices;
* a global-shape mismatch raises ``ValueError``;
* the driver at 2 ranks of ``"model"``: SIGTERM on one rank stops both at
  the same step, the collective emergency save, and the resumed run ends
  on the uninterrupted run's bits.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.training import checkpoint as JCK  # noqa: E402
from repro.training.optimizer import AdamState as JAdamState  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import checkpoint as TCK  # noqa: E402
from repro_torch.training.optimizer import Adam, AdamState  # noqa: E402

pytestmark = pytest.mark.slow  # multi-process, like tests/test_distributed_ops.py

ROOT = Path(__file__).resolve().parents[1]
ARCH = "olmoe-1b-7b"

ELASTIC = textwrap.dedent(
    """\
    import sys
    sys.path.insert(0, "src")
    sys.path.insert(0, "tests")
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_leaves
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import lm as TLM
    from repro_torch.training.optimizer import Adam, AdamState
    from test_torch_lm_train import train_batch

    rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    cfg = get_config({ARCH!r}).smoke()
    whole = T.init_params(0, cfg, device="cpu")
    opt = Adam(lr=1e-3)

    def placed(model):
        rules = SH.ShardingRules(make_host_mesh(model=model, device="cpu"))
        specs = SH.tree_shardings(rules, T.abstract_params(cfg), T.logical_axes(cfg))
        like = SH.shard_tree(whole, specs, rules, device="cpu")
        return rules, (specs, AdamState(None, specs, specs)), (like, opt.init(like))

    def leaves(state):
        p, o = state
        return tree_leaves(p) + [o.step] + tree_leaves(o.mu) + tree_leaves(o.nu)

    def bitwise(a, b):
        return all(x.dtype == y.dtype and x.shape == y.shape
                   and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
                   for x, y in zip(leaves(a), leaves(b)))

    res = {{}}
    rules, shardings, (p, o) = placed(2)
    nd, di = rules.size(("data",)), rules.axis_index(("data",))
    batch = {{k: torch.from_numpy(TLM.shard_rows(v, 2, nd, di)) for k, v in train_batch(cfg).items()}}
    with SH.use_rules(rules):
        state = TLM.make_train_step(cfg, opt, TLM.TrainSettings(n_micro=2))(p, o, batch)[:2]
        path = CK.save_checkpoint(tmp + "/port", 1, state, shardings=shardings)
        gathered = SH.unshard_tree(state, shardings, rules)
        _, back = CK.restore_checkpoint(tmp + "/port/step_0000000001", state,
                                        shardings=shardings, device="cpu")
        res["2x2"] = bitwise(back, state)
        _, jax_state = CK.restore_checkpoint(tmp + "/jax/step_0000000002", (p, o),
                                             shardings=shardings, device="cpu")
        source = CK.restore_checkpoint(tmp + "/jax/step_0000000002", (whole, opt.init(whole)),
                                       device="cpu")[1]
        res["jax_onto_2x2"] = bitwise(SH.unshard_tree(jax_state, shardings, rules), source)
    for name, model in (("1x4", 4), ("4x1", 1)):
        rules, shardings, like = placed(model)
        with SH.use_rules(rules):
            _, restored = CK.restore_checkpoint(tmp + "/port/step_0000000001", like,
                                                shardings=shardings, device="cpu")
            res[name] = bitwise(SH.unshard_tree(restored, shardings, rules), gathered)
            res[name + "_parts"] = bitwise(restored, SH.shard_tree(gathered, shardings, rules,
                                                                    device="cpu"))
    res["writer"] = path is not None
    print("RESULT " + repr(res))
    dist.destroy_process_group()
    """
).format(ARCH=ARCH)

REFERENCE_RESTORE = textwrap.dedent(
    """\
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.distributed.sharding import ShardingRules, tree_shardings, use_rules
    from repro.models import transformer as T
    from repro.training.checkpoint import restore_checkpoint
    from repro.training.optimizer import AdamState

    path = sys.argv[1]
    cfg = get_config({ARCH!r}).smoke()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
    rules = ShardingRules(mesh)
    with mesh, use_rules(rules):
        ps = tree_shardings(rules, T.abstract_params(cfg), T.logical_axes(cfg))
        like = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), T.abstract_params(cfg))
        f32 = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, jnp.float32), like)
        tree = (like, AdamState(jnp.zeros((), jnp.int32), f32, f32))
        sh = (ps, AdamState(NamedSharding(mesh, P()), ps, ps))
        step, got = restore_checkpoint(path, tree, shardings=sh)
    flat = jax.tree_util.tree_leaves(got)
    shards = jax.tree_util.tree_leaves(sh)
    placed = all(a.sharding == s for a, s in zip(flat, shards))
    np.savez(sys.argv[2], step=step, placed=placed, **{{f"l{{i}}": np.asarray(a)
                                                       for i, a in enumerate(flat)}})
    """
).format(ARCH=ARCH)


def _world(script: str, n: int, tmp: Path, *args) -> list[str]:
    init = tmp / f"rendezvous_{len(list(tmp.glob('rendezvous_*')))}"
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(n), str(init),
                               *map(str, args)], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(n)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
        outs.append(out)
    return outs


def _jax_state(cfg):
    """Seeded params and Adam moments of the smoke config, numpy."""
    rng = np.random.default_rng(7)
    params = TT.params_to_numpy(TT.init_params(1, cfg, device="cpu"))
    mu = _map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    nu = _map(lambda a: rng.random(a.shape).astype(np.float32), params)
    return params, mu, nu


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    cfg = get_config(ARCH).smoke()
    p, mu, nu = _jax_state(cfg)
    JCK.save_checkpoint(tmp / "jax", 2, (_map(jnp.asarray, p), JAdamState(
        jnp.asarray(2, jnp.int32), _map(jnp.asarray, mu), _map(jnp.asarray, nu))))
    outs = _world(ELASTIC, 4, tmp, tmp)
    results = [eval(ln[len("RESULT "):]) for out in outs for ln in out.splitlines()
               if ln.startswith("RESULT ")]
    return tmp, cfg, results


@pytest.mark.parametrize("key", ["2x2", "1x4", "4x1", "1x4_parts", "4x1_parts"])
def test_saved_at_2x2_restores_bitwise_on_other_meshes(elastic, key):
    _, _, results = elastic
    assert len(results) == 4 and all(r[key] is True for r in results)
    assert [r["writer"] for r in results] == [True, False, False, False]


def test_saved_at_2x2_restores_on_one_rank(elastic):
    """The checkpoint's whole leaves onto one rank, through ``shardings=``
    under a ``HostMesh`` and plainly, the same bits."""
    tmp, cfg, _ = elastic
    path = tmp / "port" / "step_0000000001"
    whole = TT.init_params(0, cfg, device="cpu")
    like = (whole, Adam().init(whole))
    rules = TS.ShardingRules(TS.HostMesh(("data", "model")))
    specs = TS.tree_shardings(rules, TT.abstract_params(cfg), TT.logical_axes(cfg))
    with TS.use_rules(rules):
        s1, a = TCK.restore_checkpoint(path, like, shardings=(specs, AdamState(None, specs, specs)),
                                       device="cpu")
    s2, b = TCK.restore_checkpoint(path, like, device="cpu")
    manifest = json.loads((path / "MANIFEST.json").read_text())
    files = [np.load(path / e["file"]) for e in manifest["leaves"]]
    for x, y, f in zip(TCK._flatten_with_paths(a), TCK._flatten_with_paths(b), files):
        assert torch.equal(x[1], y[1]) and np.array_equal(x[1].numpy(), f), x[0]
    assert s1 == s2 == 1


def test_jax_checkpoint_restores_onto_a_port_mesh(elastic):
    _, _, results = elastic
    assert all(r["jax_onto_2x2"] is True for r in results)


def test_port_checkpoint_restores_into_reference_with_shardings(elastic):
    tmp, _, _ = elastic
    path = tmp / "port" / "step_0000000001"
    out = tmp / "reference.npz"
    proc = subprocess.run([sys.executable, "-c", REFERENCE_RESTORE, str(path), str(out)],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(out)
    assert int(got["step"]) == 1 and bool(got["placed"])
    manifest = json.loads((path / "MANIFEST.json").read_text())
    for i, e in enumerate(manifest["leaves"]):
        want = np.load(path / e["file"])
        assert got[f"l{i}"].dtype == want.dtype and got[f"l{i}"].tobytes() == want.tobytes(), e
    assert len(manifest["leaves"]) == len([k for k in got.files if k.startswith("l")])


class _Mesh:
    """Duck-typed (1, 2) mesh: its rank is part 0 of every cut, no group."""

    axis_names = ("data", "model")
    shape = {"data": 1, "model": 2}


def test_global_shape_mismatch_raises(tmp_path):
    cfg = get_config(ARCH).smoke()
    whole = TT.init_params(0, cfg, device="cpu")
    TCK.save_checkpoint(tmp_path, 3, whole)
    rules = TS.ShardingRules(_Mesh())
    specs = TS.tree_shardings(rules, TT.abstract_params(cfg), TT.logical_axes(cfg))
    path = TCK.latest_checkpoint(tmp_path)
    part = TS.shard_tree(whole, specs, rules, device="cpu")
    with TS.use_rules(rules):
        step, got = TCK.restore_checkpoint(path, part, shardings=specs, device="cpu")
    assert step == 3
    for (k, a), (_, b) in zip(TCK._flatten_with_paths(got), TCK._flatten_with_paths(part)):
        assert torch.equal(a, b), k
    with TS.use_rules(rules), pytest.raises(ValueError, match="ckpt shape"):
        TCK.restore_checkpoint(path, whole, shardings=specs, device="cpu")


DRIVER = textwrap.dedent(
    """\
    import os, signal, sys
    sys.path.insert(0, "src")
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train

    rank, world, init, mode, ckpt = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:]
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    # the driver's host mesh, its ranks on "model"
    train.make_host_mesh = lambda device="cuda": M.make_host_mesh(model=world, device=device)
    if mode == "kill" and rank == 1:  # SIGTERM on one rank, as its third step is called
        make = train.make_train_step

        def make_train_step(*a, **k):
            step, calls = make(*a, **k), [0]

            def counted(*args):
                calls[0] += 1
                if calls[0] == 3:
                    os.kill(os.getpid(), signal.SIGTERM)
                return step(*args)

            return counted

        train.make_train_step = make_train_step
    try:
        losses = train.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--steps", "6",
                             "--batch", "4", "--seq", "16", "--n-micro", "2", "--log-every", "1",
                             "--ckpt-dir", ckpt])
        print("LOSSES " + repr(losses))
    except SystemExit as exc:
        print("EXIT", exc.code)
    dist.destroy_process_group()
    """
)


def _final(ckpt_dir: Path, step: int):
    path = ckpt_dir / "gemma-2b" / f"step_{step:010d}"
    manifest = json.loads((path / "MANIFEST.json").read_text())
    return manifest, {e["key"]: np.load(path / e["file"]) for e in manifest["leaves"]}


def test_collective_sigterm_save_resumes_bitwise_at_2_ranks(tmp_path):
    full = _world(DRIVER, 2, tmp_path, "full", tmp_path / "a")
    killed = _world(DRIVER, 2, tmp_path, "kill", tmp_path / "b")
    assert all("EXIT 143" in out for out in killed), killed
    manifest, _ = _final(tmp_path / "b", 3)
    assert manifest["extra"] == {"emergency": True}
    assert len(list((tmp_path / "b" / "gemma-2b").glob("step_*"))) == 1
    rest = _world(DRIVER, 2, tmp_path, "resume", tmp_path / "b")
    losses = [eval(ln[len("LOSSES "):]) for ln in full[0].splitlines() if ln.startswith("LOSSES")]
    again = [eval(ln[len("LOSSES "):]) for ln in rest[0].splitlines() if ln.startswith("LOSSES")]
    assert len(losses[0]) == 6 and again[0] == losses[0][3:]
    ma, a = _final(tmp_path / "a", 6)
    mb, b = _final(tmp_path / "b", 6)
    assert [e["key"] for e in ma["leaves"]] == [e["key"] for e in mb["leaves"]]
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
