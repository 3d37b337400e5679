"""A mamba2 block head-parallel over ``"ssm_heads"`` at 4 gloo ranks,
against the reference's GSPMD block on 4 forced host devices and the
port's 1-rank block.

The reference jits ``mamba2_fwd`` (and its gradient, and two decode steps
continued from the state it emits) with its params placed by its own
``tree_shardings`` over the block's specs, the input's rows over
``"batch"`` and the state as ``cache_logical_axes`` places it, in two
subprocesses (one a mesh), on seeded weights and the one-ulp nudge of
them.  The port's 4 ranks place the same weights with ``shard_tree``, each
runs its rows, sums the gradients of its parts over ``"data"`` and makes
them whole over ``"model"``.

Cases: zamba2's smoke block with 16 heads (``h16``: cut at 2 and at 4) and
with 2 (``h2``, head dim 64: cut at 2, its ``w_in``'s 274 columns cut
inside the ``x`` segment; whole at 4, where ``conv_w``, ``conv_b``,
``w_out`` and the ``conv`` state stay cut on ``d_in``), on the ("data",
"model") meshes (2, 2) and (1, 4), each at two inputs: 4 rows of 8 tokens
(a rank's 16 or 32 tokens x 4 bytes under ``d_model`` 64 x 4: the
activation route) and 8 rows of 32 (the weight route).  Limits: each
metric within ``ULPS`` times what the nudge moves it by in the reference
on the same mesh, or ``FLOOR``, as ``tests/test_torch_lm_train.py``
holds a step.  Measured (CPU): at most 0.27 of a limit against the
reference, 0.10 against the port's 1-rank block (which the block whole at
4 ranks equals bitwise).

The two collectives the block needs, ``sharding.gather_partials`` (backward
a reduce-scatter) and ``sharding.sum_partials`` (backward an all-reduce),
are held directly on seeded values: with either backward swapped for the
existing op's (``gather_dim``'s keeps this rank's slice, ``reduce_from``'s
is the identity), their test and the block's gradients fail.
"""
import functools
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.models import mamba2 as TM2  # noqa: E402
from repro_torch.models.layers import init_from_specs, tree_map  # noqa: E402

pytestmark = pytest.mark.slow  # multi-process, like tests/test_torch_lm_tp.py

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
#: case -> ssm head dim of zamba2's smoke block (16 or 2 heads)
CASES = {"h16": 8, "h2": 64}
#: input -> (rows, tokens): a rank's tokens x 4 B under / over d_model x 4 B
INPUTS = {"act": (4, 8), "weight": (8, 32)}
ULPS = 8
FLOOR = {"y": 1e-6, "grads": 1e-5, "conv": 1e-6, "ssm": 1e-6, "dec_y": 1e-6,
         "dec_conv": 1e-6, "dec_ssm": 1e-6}
#: the state's part: the dimension each of ``conv`` and ``ssm`` is cut on
STATE_DIMS = {"conv": 2, "ssm": 1}
DECODE_STEPS = 2


def cfg_of(case):
    return tget_config("zamba2-7b").smoke().replace(ssm_head_dim=CASES[case])


@functools.lru_cache(maxsize=None)
def weights(case) -> dict:
    """The block's seeded params (the port's init, each leaf moved off its
    init's zeros and ones so every leaf takes a gradient), as numpy."""
    cfg = cfg_of(case)
    gen = torch.Generator().manual_seed(0)
    p = init_from_specs(gen, TM2.mamba2_specs(cfg), cfg)
    p = tree_map(lambda t: t + 0.1 * torch.randn(t.shape, generator=gen), p)
    return tree_map(lambda t: t.numpy(), p)


def inputs(case, name) -> dict:
    """Seeded block inputs: the prompt ``x``, ``DECODE_STEPS`` single
    tokens, and the coefficients of the loss ``sum(y * coef)``."""
    cfg = cfg_of(case)
    b, t = INPUTS[name]
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x": f(b, t, cfg.d_model), "steps": [f(b, 1, cfg.d_model)
                                                for _ in range(DECODE_STEPS)],
            "coef": f(b, t, cfg.d_model)}


def nudged(tree, seed=0):
    rng = np.random.default_rng(seed)
    return {k: (tree[k] * (1 + 2.0 ** -23 * np.sign(rng.standard_normal(tree[k].shape))))
            .astype(np.float32) for k in sorted(tree)}


def _np_weights(tree):
    """The block's params flattened to ``{"norm/scale": ..., ...}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def _nest(flat):
    out = {}
    for k, v in flat.items():
        if "/" in k:
            a, b = k.split("/")
            out.setdefault(a, {})[b] = v
        else:
            out[k] = v
    return out


REFERENCE = textwrap.dedent(
    """\
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    sys.path.insert(0, "tests")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding
    from repro.configs import get_config
    from repro.distributed.sharding import ShardingRules, tree_shardings, use_rules
    from repro.models import mamba2 as M2
    from repro.models.layers import abstract_from_specs, logical_from_specs
    from test_torch_mamba2_tp import (CASES, INPUTS, STATE_AXES, _nest, _np_weights, inputs,
                                      nudged, weights)

    shape, out = tuple(map(int, sys.argv[1].split("x"))), sys.argv[2]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(*shape), ("data", "model"))
    res = {}
    for case, hd in CASES.items():
        cfg = get_config("zamba2-7b").smoke().replace(ssm_head_dim=hd)
        specs = M2.mamba2_specs(cfg)
        rules = ShardingRules(mesh)
        with mesh, use_rules(rules):
            ps = tree_shardings(rules, abstract_from_specs(specs, cfg), logical_from_specs(specs))
            put = lambda v, lg: jax.device_put(v, NamedSharding(mesh, rules.spec(lg, v.shape)))
            fwd = jax.jit(lambda p, x: M2.mamba2_fwd(p, x, cfg, emit_state=True))
            grad = jax.jit(jax.grad(lambda p, x, c: jnp.sum(M2.mamba2_fwd(p, x, cfg)[0] * c)))
            dec = jax.jit(lambda p, x, s: M2.mamba2_decode(p, x, s, cfg))
            for name in INPUTS:
                inp = inputs(case, name)
                x = put(jnp.asarray(inp["x"]), ("batch", "seq", "embed"))
                for wname, w in (("base", _np_weights(weights(case))),
                                 ("nudged", nudged(_np_weights(weights(case))))):
                    p = jax.tree_util.tree_map(jax.device_put, _nest(
                        {k: jnp.asarray(v) for k, v in w.items()}), ps)
                    y, st = fwd(p, x)
                    g = grad(p, x, jnp.asarray(inp["coef"]))
                    r = {"y": np.asarray(y), "conv": np.asarray(st["conv"]),
                         "ssm": np.asarray(st["ssm"]),
                         "grads": {k: np.asarray(v) for k, v in _np_weights(g).items()}}
                    st = {k: put(v, STATE_AXES[k]) for k, v in st.items()}
                    for i, xt in enumerate(inp["steps"]):
                        yt, st = dec(p, put(jnp.asarray(xt), ("batch", "seq", "embed")), st)
                        r[f"dec_y{i}"] = np.asarray(yt)
                    r["dec_conv"], r["dec_ssm"] = np.asarray(st["conv"]), np.asarray(st["ssm"])
                    res[f"{case}/{name}/{wname}"] = r
    np.save(out, res, allow_pickle=True)
    """
)

#: the state's logical axes without the layer axis (the block's own state)
STATE_AXES = {k: v[1:] for k, v in TM2.STATE_AXES.items()}

PORT = textwrap.dedent(
    """\
    import sys
    sys.path.insert(0, "src")
    sys.path.insert(0, "tests")
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.comm_analysis import CollectiveMode
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import mamba2 as M2
    from repro_torch.models.layers import abstract_from_specs, logical_from_specs, tree_leaves
    from test_torch_mamba2_tp import (CASES, INPUTS, _nest, _np_weights, cfg_of, inputs,
                                      op_backwards, weights)

    rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    res = {}
    for mesh_name, model in (("2x2", 2), ("1x4", 4)):
        rules = SH.ShardingRules(make_host_mesh(model=model, device="cpu"))
        dgroup = rules.group(("data",))
        res[mesh_name + "/ops"] = op_backwards(rules)
        for case in CASES:
            cfg = cfg_of(case)
            specs = M2.mamba2_specs(cfg)
            pspecs = SH.tree_shardings(rules, abstract_from_specs(specs, cfg),
                                       logical_from_specs(specs), record=False)
            whole = _nest({k: torch.from_numpy(v) for k, v in _np_weights(weights(case)).items()})
            for name in INPUTS:
                inp = inputs(case, name)
                with SH.use_rules(rules):
                    rows = SH.batch_cut()
                    cut = M2.head_cut(cfg)
                    cuts = M2.state_cuts(cfg)
                b = inp["x"].shape[0]
                sl = slice(None) if rows is None else rows.part(b)
                x = torch.from_numpy(inp["x"][sl])
                params = SH.map_specs(
                    lambda t, s: t.detach().clone().requires_grad_(True),
                    SH.shard_tree(whole, pspecs, rules, device="cpu"), pspecs)
                with SH.use_rules(rules):
                    route = M2.in_route(cfg, x.shape[0] * x.shape[1], params["w_in"])
                    with CollectiveMode() as fwd_mode:
                        y, st = M2.mamba2_fwd(params, x, cfg, emit_state=True)
                    loss = (y * torch.from_numpy(inp["coef"][sl])).sum()
                    with CollectiveMode() as bwd_mode:
                        loss.backward()
                grads = SH.map_specs(lambda t, s: t.grad, params, pspecs)
                for g in tree_leaves(grads):  # the data-parallel sum of the parts
                    if dgroup is not None:
                        dist.all_reduce(g, group=dgroup)
                grads = SH.unshard_tree(grads, pspecs, rules)
                r = {"y": y.detach().numpy(), "rows": (sl.start, sl.stop),
                     "conv": st["conv"].detach().numpy(), "ssm": st["ssm"].detach().numpy(),
                     "grads": {k: v.numpy() for k, v in _np_weights(grads).items()},
                     "route": route, "heads_cut": None if cut is None else cut.size,
                     "state_cuts": {k: None if c is None else (c.index, c.size)
                                    for k, c in cuts.items()},
                     "fwd_collectives": [(c["op"], sum(c["result_bytes"].values()))
                                         for c in fwd_mode.records],
                     "bwd_collectives": [c["op"] for c in bwd_mode.records]}
                st = {k: v.detach() for k, v in st.items()}
                with torch.no_grad(), SH.use_rules(rules):
                    for i, xt in enumerate(inp["steps"]):
                        yt, st = M2.mamba2_decode(params, torch.from_numpy(xt[sl]), st, cfg)
                        r[f"dec_y{i}"] = yt.numpy()
                r["dec_conv"], r["dec_ssm"] = st["conv"].numpy(), st["ssm"].numpy()
                res[f"{mesh_name}/{case}/{name}"] = r
    np.save(out + f".{rank}.npy", res, allow_pickle=True)
    dist.destroy_process_group()
    """
)


def op_backwards(rules) -> dict:
    """``gather_partials`` and ``sum_partials`` over the model group on
    seeded values: each rank ``r`` holds ``x_r`` and takes the loss
    ``sum(op(x_r) * c_r)``; the true gradient of ``x_r`` for the sum of
    the ranks' losses is, for the gather, the sum over ranks of their
    ``c``'s rows of part ``r``, and for the sum, the sum of the ranks'
    ``c``.  Returns each op's forward error and the worst error of its
    gradient against that (both exact sums of small integers)."""
    from repro_torch.distributed import sharding as SH

    cut = SH.Cut(("model",), rules.size(("model",)), rules.axis_index(("model",)),
                 rules.group(("model",)))
    n = cut.size

    def c_of(r, shape):
        return torch.from_numpy(np.random.default_rng(100 + r).integers(-4, 5, shape)
                                .astype(np.float32))

    def x_of(r):
        return torch.from_numpy(np.random.default_rng(r).integers(-4, 5, (2, 3))
                                .astype(np.float32))

    out = {}
    x = x_of(cut.index).requires_grad_(True)
    y = SH.gather_partials(x, cut, 0)
    (y * c_of(cut.index, (2 * n, 3))).sum().backward()
    want_y = torch.cat([x_of(r) for r in range(n)])
    want_g = sum(c_of(r, (2 * n, 3))[2 * cut.index:2 * cut.index + 2] for r in range(n))
    out["gather"] = (float((y - want_y).abs().max()), float((x.grad - want_g).abs().max()))
    x = x_of(cut.index).requires_grad_(True)
    s = SH.sum_partials(x, cut)
    (s * c_of(cut.index, (2, 3))).sum().backward()
    want_s = sum(x_of(r) for r in range(n))
    want_g = sum(c_of(r, (2, 3)) for r in range(n))
    out["sum"] = (float((s - want_s).abs().max()), float((x.grad - want_g).abs().max()))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both references and the port's 4-rank world, run concurrently."""
    tmp = tmp_path_factory.mktemp("m2tp")
    refs = {m: subprocess.Popen([sys.executable, "-c", REFERENCE, m,
                                 str(tmp / f"ref_{m}.npy")], cwd=ROOT, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for m in MESHES}
    init = tmp / "rendezvous"
    ranks = [subprocess.Popen([sys.executable, "-c", PORT, str(r), "4", str(init),
                               str(tmp / "port")], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(4)]
    for proc in [*refs.values(), *ranks]:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
    ref = {}
    for m in MESHES:
        ref.update({f"{m}/{k}": v for k, v in
                    np.load(tmp / f"ref_{m}.npy", allow_pickle=True).item().items()})
    port = [np.load(tmp / f"port.{r}.npy", allow_pickle=True).item() for r in range(4)]
    return ref, port


@functools.lru_cache(maxsize=None)
def one_rank(case, name) -> dict:
    """The port's block with no rules: forward, state, gradients, decode."""
    cfg = cfg_of(case)
    inp = inputs(case, name)
    p = tree_map(lambda t: torch.from_numpy(t).requires_grad_(True), weights(case))
    y, st = TM2.mamba2_fwd(p, torch.from_numpy(inp["x"]), cfg, emit_state=True)
    (y * torch.from_numpy(inp["coef"])).sum().backward()
    r = {"y": y.detach().numpy(), "conv": st["conv"].detach().numpy(),
         "ssm": st["ssm"].detach().numpy(),
         "grads": _np_weights(tree_map(lambda t: t.grad.numpy(), p))}
    st = {k: v.detach() for k, v in st.items()}
    with torch.no_grad():
        for i, xt in enumerate(inp["steps"]):
            yt, st = TM2.mamba2_decode(p, torch.from_numpy(xt), st, cfg)
            r[f"dec_y{i}"] = yt.numpy()
    r["dec_conv"], r["dec_ssm"] = st["conv"].numpy(), st["ssm"].numpy()
    return r


def _part(a, rows, cut, dim):
    """Rows ``rows`` of a whole state ``a``, and ``cut``'s part of
    dimension ``dim`` (``cut`` an ``(index, size)`` or ``None``)."""
    a = a[slice(*rows)]
    if cut is None:
        return a
    k = a.shape[dim] // cut[1]
    return np.take(a, range(cut[0] * k, (cut[0] + 1) * k), axis=dim)


def _rel(a, b) -> float:
    scale = float(np.abs(b).max())
    return float(np.abs(a - b).max()) / scale if scale else float(np.abs(a).max())


def metrics(run: dict, want: dict) -> dict:
    """A rank's ``run`` against a whole run ``want``: its rows of the
    output and the decode's outputs, its parts of the states (before and
    after the decode), relative to their scale; the whole gradients, the
    worst leaf relative to its scale."""
    rows, cuts = run["rows"], run["state_cuts"]
    out = {"y": _rel(run["y"], want["y"][slice(*rows)]),
           "grads": max(_rel(run["grads"][k], want["grads"][k]) for k in want["grads"]),
           "dec_y": max(_rel(run[f"dec_y{i}"], want[f"dec_y{i}"][slice(*rows)])
                        for i in range(DECODE_STEPS))}
    for k, dim in STATE_DIMS.items():
        for pre in ("", "dec_"):
            got, whole = run[pre + k], want[pre + k]
            part = _part(whole, rows, cuts[k], dim)
            assert got.shape == part.shape, (pre + k, got.shape, part.shape)
            out[pre + k] = _rel(got, part)
    return out


def _nudge_effect(base: dict, nudge: dict) -> dict:
    """What the nudge moves each metric by, whole (every row, every part)."""
    whole = {"rows": (None, None), "state_cuts": {k: None for k in STATE_DIMS}}
    return metrics({**nudge, **whole}, base)


def within(err: dict, nudge: dict) -> dict:
    """Each metric's share of its limit (``ULPS`` x the nudge's effect, or
    the floor)."""
    return {k: err[k] / max(FLOOR[k], ULPS * nudge[k]) for k in err}


IDS = [(m, c, n) for m in MESHES for c in CASES for n in INPUTS]
PARAMS = pytest.mark.parametrize("mesh,case,name", IDS, ids=["-".join(i) for i in IDS])


@PARAMS
def test_block_matches_reference_gspmd_block(runs, mesh, case, name):
    """Every rank's rows of the output and the two decode steps', its parts
    of the emitted and decoded states, and the whole gradients of every
    leaf, against the reference's GSPMD block on the same mesh."""
    ref, port = runs
    want, nudge = ref[f"{mesh}/{case}/{name}/base"], ref[f"{mesh}/{case}/{name}/nudged"]
    lim = _nudge_effect(want, nudge)
    for r, res in enumerate(port):
        shares = within(metrics(res[f"{mesh}/{case}/{name}"], want), lim)
        assert max(shares.values()) <= 1, (r, shares)


@PARAMS
def test_block_matches_port_one_rank_block(runs, mesh, case, name):
    ref, port = runs
    lim = _nudge_effect(ref[f"{mesh}/{case}/{name}/base"], ref[f"{mesh}/{case}/{name}/nudged"])
    for r, res in enumerate(port):
        shares = within(metrics(res[f"{mesh}/{case}/{name}"], one_rank(case, name)), lim)
        assert max(shares.values()) <= 1, (r, shares)


@PARAMS
def test_heads_cut_route_and_collectives(runs, mesh, case, name):
    """Where the heads are cut (``h16`` at both meshes, ``h2`` at 2), the
    route is the one whose gather moves fewer bytes, and the forward's only
    all-gather is that route's (the projection's ``tokens x E`` or
    ``w_in``'s ``d_model x E`` values), beside two all-reduces (the norm's
    sums of squares and ``w_out``'s); its backward reduce-scatters what was
    gathered.  Where they are not (``h2`` at 4), the state's ``ssm`` is
    whole and its ``conv`` cut on ``d_in``."""
    cfg = cfg_of(case)
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    e = 2 * d_in + 2 * cfg.ssm_state + nh
    model = MESHES[mesh][1]
    for res in runs[1]:
        run = res[f"{mesh}/{case}/{name}"]
        if nh % model:
            assert run["heads_cut"] is None
            assert run["state_cuts"]["ssm"] is None and run["state_cuts"]["conv"][1] == model
            continue
        assert run["heads_cut"] == model
        rows, t = run["y"].shape[:2]
        want = "activation" if rows * t < cfg.d_model else "weight"
        assert run["route"] == want == {"act": "activation", "weight": "weight"}[name]
        gathered = rows * t * e * 4 if want == "activation" else cfg.d_model * e * 4
        fwd = run["fwd_collectives"]
        assert [c for c in fwd if c[0] == "all-gather"] == [("all-gather", gathered)]
        assert [c[0] for c in fwd].count("all-reduce") == 2 and len(fwd) == 3
        assert run["bwd_collectives"].count("reduce-scatter") == 1


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gather_and_sum_backwards_sum_the_ranks_partial_gradients(runs, mesh):
    """``gather_partials``' backward is a reduce-scatter and
    ``sum_partials``' an all-reduce: each rank's gradient is the sum of the
    ranks' partial gradients of its part, exactly (small integers)."""
    for res in runs[1]:
        ops = res[f"{mesh}/ops"]
        assert ops["gather"] == (0.0, 0.0) and ops["sum"] == (0.0, 0.0), ops
