"""The port's LM collectives and data parallelism over several processes.

The port's ranks run as ``torch.distributed`` processes on the ``gloo``
backend (a ``file://`` rendezvous in the test's own directory, so parallel
test workers never share a port); the reference runs in a subprocess with
forced host devices on the same mesh shape, ``("data", "model")`` = (2, 2).

* ``moe_fwd_a2a`` and ``embedding_gather`` at 4 ranks against the
  reference's own ``shard_map`` programs, within the reference's own
  bounds (``tests/test_distributed_ops.py``: forward 2e-4, gradient 1e-4,
  gather 1e-6), each rank holding its experts and its rows of the table as
  the specs place them;
* a 2-rank data-parallel train step (labels masked unevenly across the
  ranks) against the 1-rank step on the whole batch;
* ``ShardingRules.spec`` and its fallbacks against the reference's on
  ``tests/test_sharding_distributed.py``'s cases and on every
  architecture's parameter tree.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import lm_arch_names  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.training import lm as TLM  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

pytestmark = pytest.mark.slow  # multi-process, like tests/test_distributed_ops.py

ROOT = Path(__file__).resolve().parents[1]
FWD_TOL, GRAD_TOL, GATHER_TOL = 2e-4, 1e-4, 1e-6

CFG = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, head_dim=8,
           d_ff=32, vocab=64, pattern=("moe",), n_experts=8, top_k=2, capacity_factor=8.0,
           param_dtype="float32", act_dtype="float32", remat=False)

REFERENCE = textwrap.dedent(
    """\
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import ArchConfig
    from repro.models import moe as MOE
    from repro.models.layers import init_from_specs
    from repro.distributed.sharding import ShardingRules, use_rules
    from repro.distributed.embedding import embedding_gather

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
    cfg = ArchConfig(**{CFG})
    p = init_from_specs(jax.random.PRNGKey(0), MOE.moe_specs(cfg), cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 16))
    table = jax.random.normal(jax.random.PRNGKey(2), (64, 16))
    ids = jax.random.randint(jax.random.PRNGKey(3), (4, 12), 0, 64)
    rules = ShardingRules(mesh)
    with mesh, use_rules(rules):
        a2a = jax.jit(lambda p, x: MOE.moe_fwd_a2a(p, x, cfg))(p, x)
        g = jax.jit(jax.grad(lambda p, x: MOE.moe_fwd_a2a(p, x, cfg).sum()))(p, x)
        tbl = jax.device_put(table, rules.sharding(("vocab", "embed"), dims=(64, 16)))
        gathered = jax.jit(embedding_gather)(tbl, ids)
    out = {{"x": x, "a2a": a2a, "table": table, "ids": ids, "gathered": gathered}}
    out.update({{"p_" + k: v for k, v in p.items() if k != "norm"}})
    out["p_norm"] = p["norm"]["scale"]
    out.update({{"g_" + k: v for k, v in g.items() if k != "norm"}})
    out["g_norm"] = g["norm"]["scale"]
    np.savez(sys.argv[1], **{{k: np.asarray(v) for k, v in out.items()}})
    """
).format(CFG=repr(CFG))

PORT_COLLECTIVES = textwrap.dedent(
    """\
    import sys
    sys.path.insert(0, "src")
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs.base import ArchConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.embedding import embedding_gather
    from repro_torch.distributed.sharding import ShardingRules, use_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import logical_from_specs

    rank, world, init, ref, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:]
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    mesh = make_host_mesh(model=2, device="cpu")
    rules = ShardingRules(mesh)
    r = np.load(ref)
    cfg = ArchConfig(**{CFG})
    whole = {{k: torch.from_numpy(r["p_" + k]) for k in ("router", "wi_gate", "wi_up", "wo")}}
    whole["norm"] = {{"scale": torch.from_numpy(r["p_norm"])}}
    # each rank holds its experts (the specs cut "experts" over "model")
    specs = SH.tree_shardings(rules, MOE.moe_specs(cfg), logical_from_specs(MOE.moe_specs(cfg)))
    p = SH.shard_tree(whole, specs, rules, device="cpu")
    for t in (p["router"], p["wi_gate"], p["wi_up"], p["wo"], p["norm"]["scale"]):
        t.requires_grad_(True)
    d = rules.axis_index(("data",))
    rows = slice(2 * d, 2 * d + 2)
    tspec = rules.spec(("vocab", "embed"), (64, 16))
    with use_rules(rules):
        y = MOE.moe_fwd_a2a(p, torch.from_numpy(r["x"][rows]), cfg)
        y.sum().backward()
        table = SH.shard(torch.from_numpy(r["table"]), tspec, rules, device="cpu")
        gathered = embedding_gather(table, torch.from_numpy(r["ids"][rows]),
                                    SH.dim_cut(("vocab", "embed"), (64, 16), 0))
    dense = MOE.moe_fwd(whole, torch.from_numpy(r["x"][rows]), cfg)  # no rules: the plain path
    grads = {{k: p[k].grad for k in ("router", "wi_gate", "wi_up", "wo")}}
    grads["norm"] = p["norm"]["scale"].grad
    for g in grads.values():  # each data row's rows: sum over data
        dist.all_reduce(g, group=rules.group(("data",)))
    res = {{"y": y.detach().numpy(), "dense": dense.detach().numpy(),
            "gathered": gathered.numpy(), "d": np.int32(d),
            "m": np.int32(rules.axis_index(("model",)))}}
    res.update({{"g_" + k: v.numpy() for k, v in grads.items()}})
    np.savez(out, **res)
    dist.destroy_process_group()
    """
).format(CFG=repr(CFG))

PORT_DATA_PARALLEL = textwrap.dedent(
    """\
    import sys
    sys.path.insert(0, "src")
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingRules, use_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_leaves
    from repro_torch.training import lm as TLM
    from repro_torch.training.optimizer import Adam

    rank, world, init, batch_file, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:]
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    rules = ShardingRules(make_host_mesh(device="cpu"))
    cfg = get_config("gemma-2b").smoke()
    params = T.init_params(0, cfg, device="cpu")
    opt = Adam(lr=1e-3, eps=1e-3, grad_clip_norm=None)
    b = np.load(batch_file)
    batch = {k: torch.from_numpy(TLM.shard_rows(b[k], 2, world, rank)) for k in ("tokens", "labels")}
    with use_rules(rules):
        p2, o2, m = TLM.make_train_step(cfg, opt, TLM.TrainSettings(n_micro=2))(
            params, opt.init(params), batch)
    np.savez(out, loss=np.float32(m["loss"]), **{f"p{i}": t.numpy()
             for i, t in enumerate(tree_leaves(p2))}, **{f"m{i}": t.numpy()
             for i, t in enumerate(tree_leaves(o2.mu))})
    dist.destroy_process_group()
    """
)


def _ranks(script: str, world: int, tmp_path: Path, *args) -> list[dict]:
    init = tmp_path / "rendezvous"
    outs = [tmp_path / f"rank{r}.npz" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(world), str(init),
                               *map(str, args), str(outs[r])], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
    return [dict(np.load(o)) for o in outs]


def test_moe_a2a_and_embedding_gather_at_4_ranks_match_reference(tmp_path):
    ref_file = tmp_path / "reference.npz"
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(ref_file)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(ref_file))
    ranks = _ranks(PORT_COLLECTIVES, 4, tmp_path, ref_file)
    e_loc = CFG["n_experts"] // 2
    for res in ranks:
        rows = slice(2 * int(res["d"]), 2 * int(res["d"]) + 2)
        mine = slice(int(res["m"]) * e_loc, (int(res["m"]) + 1) * e_loc)  # its experts
        assert np.abs(res["y"] - ref["a2a"][rows]).max() < FWD_TOL
        assert np.abs(res["y"] - res["dense"]).max() < FWD_TOL  # a2a == the dense MoE
        assert np.abs(res["gathered"] - ref["table"][ref["ids"][rows]]).max() < GATHER_TOL
        assert np.abs(res["gathered"] - ref["gathered"][rows]).max() < GATHER_TOL
        for k in ("router", "norm"):
            assert np.abs(res["g_" + k] - ref["g_" + k]).max() < GRAD_TOL, k
        for k in ("wi_gate", "wi_up", "wo"):
            assert np.abs(res["g_" + k] - ref["g_" + k][mine]).max() < GRAD_TOL, k
    # the model axis's two ranks of a data row hold the same (whole) result,
    # and a whole leaf's gradient is the same on every rank
    assert np.array_equal(ranks[0]["y"], ranks[1]["y"])
    assert np.array_equal(ranks[0]["g_router"], ranks[3]["g_router"])
    assert np.array_equal(ranks[0]["g_wo"], ranks[2]["g_wo"])  # the same experts


#: a 2-rank data-parallel step against the 1-rank step on the whole batch
#: (gemma-2b smoke, fp32): the ranks sum in another order, each dividing by
#: the global label count; measured 0 (loss), 2.2e-7 (mu, of its scale) and
#: 1.2e-7 (params, absolute); limits more than three times that (the loss's
#: at about eight ulps)
DP_LOSS_RTOL, DP_MU_RTOL, DP_PARAM_ATOL = 1e-6, 7e-7, 4e-7


def test_data_parallel_step_at_2_ranks_equals_1_rank_step(tmp_path):
    cfg = tget_config("gemma-2b").smoke()
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[rng.random((8, 16)) < np.where(np.arange(8) % 4 < 2, 0.5, 0.1)[:, None]] = -1
    # rank 0's rows (0, 1, 4, 5: its half of each microbatch) about half
    # masked, rank 1's about a tenth
    np.savez(tmp_path / "batch.npz", tokens=toks, labels=labels)
    ranks = _ranks(PORT_DATA_PARALLEL, 2, tmp_path, tmp_path / "batch.npz")

    params = TT.init_params(0, cfg, device="cpu")
    opt = TO.Adam(lr=1e-3, eps=1e-3, grad_clip_norm=None)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    p2, o2, m = TLM.make_train_step(cfg, opt, TLM.TrainSettings(n_micro=2))(
        params, opt.init(params), batch)
    want_loss = float(m["loss"])
    for res in ranks:
        assert abs(float(res["loss"]) - want_loss) <= DP_LOSS_RTOL * abs(want_loss)
        for i, t in enumerate(tree_leaves(p2)):
            assert np.abs(res[f"p{i}"] - t.numpy()).max() <= DP_PARAM_ATOL
        for i, t in enumerate(tree_leaves(o2.mu)):
            scale = float(t.abs().max())
            assert np.abs(res[f"m{i}"] - t.numpy()).max() <= DP_MU_RTOL * scale
    assert ranks[0]["loss"] == ranks[1]["loss"]


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


class _FakeMesh:
    """Duck-typed mesh: .axis_names + .shape mapping (enough for rules)."""

    def __init__(self, shape: dict):
        self._shape = shape

    @property
    def axis_names(self):
        return tuple(self._shape)

    @property
    def shape(self):
        return dict(self._shape)


MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}, {"data": 1, "model": 1}]
CASES = [
    (("embed", "kv_heads", "head_dim"), (2048, 8, 256)),
    (("experts", "embed", "mlp"), (16, 4096, 6400)),
    (("batch", "seq"), (256, 4096)),
    (("batch",), (8,)),
    (("batch", "seq", "vocab"), (8, 128, 256000)),
    (("layers", "decode_batch", "kv_seq_model", "kv_heads", "head_dim"), (18, 4, 4096, 1, 256)),
    ((None, "heads", "nonexistent"), (3, 32, 5)),
]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s.values())))
@pytest.mark.parametrize("overrides", [None, JS.LONG_CONTEXT_OVERRIDES], ids=["default", "long"])
def test_sharding_rules_spec_and_fallbacks_equal_reference(shape, overrides):
    assert TS.DEFAULT_RULES == JS.DEFAULT_RULES
    assert TS.LONG_CONTEXT_OVERRIDES == JS.LONG_CONTEXT_OVERRIDES
    jr, tr = JS.ShardingRules(_FakeMesh(shape), overrides), TS.ShardingRules(_FakeMesh(shape),
                                                                             overrides)
    for logical, dims in CASES:
        for d in (dims, None):
            assert tuple(jr.spec(logical, d)) == tr.spec(logical, d), (logical, d)
    assert tr.fallbacks == jr.fallbacks
    with JS.use_rules(jr), TS.use_rules(tr):
        for kv in (1, 2, 8, 16, 32):
            assert TS.kv_seq_axis(kv) == JS.kv_seq_axis(kv)
    assert TS.active_rules() is None and TS.kv_seq_axis(1) == "kv_seq"


@pytest.mark.parametrize("arch", lm_arch_names())
def test_tree_shardings_equal_reference_on_the_production_mesh(arch):
    """Every parameter's spec and the fallback log, 16 x 16 and 2 x 16 x 16."""
    j, t = jget_config(arch), tget_config(arch)
    for shape in MESHES[:2]:
        jr, tr = JS.ShardingRules(_FakeMesh(shape)), TS.ShardingRules(_FakeMesh(shape))
        want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda lg, a: tuple(jr.spec(lg, dims=a.shape)), JT.logical_axes(j),
            JT.abstract_params(j), is_leaf=JS.is_logical_leaf), is_leaf=lambda v: isinstance(
                v, tuple))
        got = TS.tree_shardings(tr, TT.abstract_params(t), TT.logical_axes(t))
        assert [tuple(v) for v in tree_leaves(got)] == want
        assert tr.fallbacks == jr.fallbacks


def test_host_mesh_without_a_process_group():
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    mesh = make_host_mesh(device="cpu")
    assert isinstance(mesh, TS.HostMesh) and TS.mesh_shape(mesh) == {"data": 1, "model": 1}
    rules = TS.ShardingRules(mesh)
    assert rules.group(("model",)) is None and rules.axis_index(("data", "model")) == 0
    with pytest.raises(ValueError):
        make_host_mesh(model=2, device="cpu")
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"need {n} devices, have 1"):
            make_production_mesh(multi_pod=multi, device="cpu")
    x = torch.ones(3)
    assert TS.constrain(x, ("batch",)) is x
    for fn in (TS.copy_to, TS.reduce_from, TS.gather_from, TS.all_to_all):
        assert fn(x, None) is x
