"""Sharded serving: decode caches cut along the sequence (ring-decode
attention) and int8 ``QTensor`` shards, at 4 gloo ranks, against the
reference's GSPMD serving on 4 forced host devices and the port's 1-rank
run.

The reference places its params by ``tree_shardings`` (over
``abstract_quantized``'s trees for int8: the payload cut by the weight's
spec, the scale whole) and its caches by ``tree_shardings`` over
``cache_logical_axes(seq_axis=kv_seq_axis(n_kv))``, then runs its jitted
prefill and decode steps; GSPMD combines the softmax across the cache's
pieces.  The port's ranks place the same seeded weights (the port's
``init_params(0)``, and its int8 bake, carried as numpy) with
``shard_tree`` and run ``forward_with_cache``/``decode_step`` under the
same rules: each holds its slots of every cut cache, the rank owning the
new token's slot writes it, and the ranks combine their partial softmax
statistics (``layers._ring_decode``).

Cells (``CELLS``): the smoke configs of gemma-2b (one kv head, so
``"kv_seq_model"`` at both meshes), gemma3-12b (ring caches of 16 and
global ones), h2o-danube (ring), phi4-mini, phi3.5-moe and internvl2 (two
kv heads: cut heads at 2, a cut sequence at 4) and zamba2 (four kv heads:
its shared attention's caches whole under the default rules) on the
("data", "model") meshes (2, 2) and (1, 4), caches of 32, a prompt of 20
and 4 decode steps; an early decode (a prompt of 6: at model = 4 the
slots are 8 a rank, so three ranks hold no valid slot for the first two
steps, and their share must come out exactly zero); a length of 30, which
4 ranks do not divide (it stays whole, as in the reference) and 2 do; the
long-context rules (``LONG_CONTEXT_OVERRIDES``) on (2, 2), where the
sequence is cut over ``"data"`` (and over both axes for one kv head) while
the prefill's rows are cut over ``"data"`` and a decode's are not; int8
(``default_lm_policy``) serving of gemma-2b, olmoe and zamba2.

Planted in a copy of the port, a missing rescale of the partial statistics
(``corr`` left out of the combine) fails every cut cell here.
"""
import functools
import importlib.util
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
from repro.models import quantized as JQ  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs import lm_arch_names as tarch_names  # noqa: E402
from repro_torch.core.sequential import stack_layers, unstack_layers  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.specs import SHAPES, skip_reason  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import quantized as TQ  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from test_torch_lm_distributed import MESHES as RULE_MESHES  # noqa: E402
from test_torch_lm_distributed import _FakeMesh  # noqa: E402

pytestmark = pytest.mark.slow  # multi-process, like tests/test_torch_lm_tp.py

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
SERVE_ARCHS = ("gemma-2b", "gemma3-12b", "h2o-danube-3-4b", "phi4-mini-3.8b",
               "phi3.5-moe-42b-a6.6b", "internvl2-1b", "zamba2-7b")
#: scenario -> (cache length, prompt, decode steps)
SCENARIOS = {"main": (32, 20, 4), "early": (32, 6, 4), "len30": (30, 20, 4)}
ROWS = 4
INT8_ARCHS = ("gemma-2b", "olmoe-1b-7b", "zamba2-7b")
LONG_ARCHS = ("gemma-2b", "h2o-danube-3-4b", "zamba2-7b")
#: the quantised leaf layouts ``qtensor_parts`` places: 4-D wq/wk/wv
#: (scales kept on (0, 2, 3)), stacked matrices (0, -1), experts, zamba2's
#: unstacked shared block, rwkv6's stacked square matrices
PARTS_ARCHS = ("gemma-2b", "olmoe-1b-7b", "zamba2-7b", "rwkv6-7b")


def _cells() -> dict:
    """key -> (mesh, architecture, scenario, long-context rules, int8)."""
    cells = {}
    for m in MESHES:
        for a in SERVE_ARCHS:
            cells[f"{m}/{a}/main"] = (m, a, "main", False, False)
        for a in ("gemma-2b", "gemma3-12b"):
            cells[f"{m}/{a}/early"] = (m, a, "early", False, False)
        for a in ("gemma-2b", "phi4-mini-3.8b"):
            cells[f"{m}/{a}/len30"] = (m, a, "len30", False, False)
        for a in INT8_ARCHS:
            cells[f"{m}/{a}/int8"] = (m, a, "main", False, True)
    for a in LONG_ARCHS:
        cells[f"2x2/{a}/long"] = ("2x2", a, "main", True, False)
    return cells


CELLS = _cells()


def serve_tokens(vocab: int, n: int) -> np.ndarray:
    """Seeded tokens: ``ROWS`` rows of ``n``."""
    return np.random.default_rng(3).integers(0, vocab, (ROWS, n)).astype(np.int32)


def weights_key(arch: str, int8: bool) -> str:
    return arch + ("/int8" if int8 else "")


def port_weights(arch: str, int8: bool):
    """The port's seeded params (its int8 bake with ``default_lm_policy``)."""
    cfg = tget_config(arch).smoke()
    params = TT.init_params(0, cfg, device="cpu")
    return TQ.quantize_lm_params(params, TQ.default_lm_policy(cfg)) if int8 else params


def to_jax(tree, cfg):
    """A ``params_to_numpy`` tree as the reference's params (``QTensor``
    leaves travel as ``(q, scale, axis)``)."""
    import jax.numpy as jnp

    from repro.core.quantization import QTensor as JQTensor

    specs = JT.build_specs(cfg)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, tuple):
            q, scale, axis = t
            return JQTensor(jnp.asarray(q), jnp.asarray(scale), axis)
        return jnp.asarray(t, jnp.dtype(s.dtype or cfg.param_dtype))

    return walk(tree, specs)


def _kv_paths(tree, path=""):
    """The attention cache leaves of a cache tree: ``(path, leaf)``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _kv_paths(tree[k], f"{path}/{k}")]
    return [(path, tree)] if path.rsplit("/", 1)[-1] in ("k", "v") else []


REFERENCE = textwrap.dedent(
    """\
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path[:0] = ["src", "tests"]
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.distributed.sharding import (LONG_CONTEXT_OVERRIDES, ShardingRules, kv_seq_axis,
                                            tree_shardings, use_rules)
    from repro.models import transformer as T
    from repro.models.quantized import abstract_quantized, default_lm_policy
    from repro.training import lm as LM
    from test_torch_lm_tp_serve import (CELLS, MESHES, ROWS, SCENARIOS, _kv_paths, serve_tokens,
                                        to_jax, weights_key)

    mesh_name, data, out = sys.argv[1:]
    weights = np.load(data, allow_pickle=True).item()
    devices = np.asarray(jax.devices()).reshape(*MESHES[mesh_name])
    mesh = jax.sharding.Mesh(devices, ("data", "model"))
    res = {}
    for key, (m, arch, scen, long, int8) in CELLS.items():
        if m != mesh_name:
            continue
        cfg = get_config(arch).smoke()
        L, P, D = SCENARIOS[scen]
        toks = jnp.asarray(serve_tokens(cfg.vocab, P + D))
        rules = ShardingRules(mesh, LONG_CONTEXT_OVERRIDES if long else None)
        with mesh, use_rules(rules):
            aparams, logical = T.abstract_params(cfg), T.logical_axes(cfg)
            if int8:
                aparams, logical = abstract_quantized(aparams, logical, default_lm_policy(cfg))
            ps = tree_shardings(rules, aparams, logical)
            p = jax.tree_util.tree_map(jax.device_put,
                                       to_jax(weights[weights_key(arch, int8)], cfg), ps)
            cs = tree_shardings(rules, T.cache_shapes(cfg, ROWS, L),
                                T.cache_logical_axes(cfg, kv_seq_axis(cfg.n_kv_heads)))
            prefill = jax.jit(LM.make_prefill_step(cfg, L))
            decode = jax.jit(LM.make_decode_step(cfg, L))
            logits, caches = prefill(p, {"tokens": toks[:, :P]})
            caches = jax.tree_util.tree_map(jax.device_put, caches, cs)
            got = [np.asarray(logits)]
            for i in range(D):
                logits, caches = decode(p, toks[:, P + i:P + i + 1], caches, jnp.int32(P + i))
                got.append(np.asarray(logits))
        first = devices.flat[0]  # the port's rank 0: data 0, model 0
        shapes = {path: tuple(next(s for s in leaf.addressable_shards
                                   if s.device == first).data.shape)
                  for path, leaf in _kv_paths(caches)}
        res[key] = {"logits": got, "shapes": shapes}
    np.save(out, res, allow_pickle=True)
    """
)

PORT = textwrap.dedent(
    """\
    import sys
    sys.path[:0] = ["src", "tests"]
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.quantized import abstract_quantized, default_lm_policy
    from test_torch_lm_tp_serve import (CELLS, MESHES, SCENARIOS, _kv_paths, qtensor_parts,
                                        rows_of, serve_tokens, spec_parts, weights_key)

    rank, world, init, data, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:]
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
    weights = np.load(data, allow_pickle=True).item()
    res = {}
    for mesh_name, (_, model) in MESHES.items():
        mesh = make_host_mesh(model=model, device="cpu")
        rules_of = {False: SH.ShardingRules(mesh),
                    True: SH.ShardingRules(mesh, SH.LONG_CONTEXT_OVERRIDES)}
        res[mesh_name + "/parts"] = qtensor_parts(rules_of[False])
        for key, (m, arch, scen, long, int8) in CELLS.items():
            if m != mesh_name:
                continue
            cfg = get_config(arch).smoke()
            rules = rules_of[long]
            n, P, D = SCENARIOS[scen]
            toks = torch.from_numpy(serve_tokens(cfg.vocab, P + D))
            whole = T.params_from_numpy(weights[weights_key(arch, int8)], cfg)
            aparams, logical = T.abstract_params(cfg), T.logical_axes(cfg)
            if int8:
                aparams, logical = abstract_quantized(aparams, logical, default_lm_policy(cfg))
            params = SH.shard_tree(whole, SH.tree_shardings(rules, aparams, logical), rules,
                                   device="cpu")
            with SH.use_rules(rules), torch.no_grad():
                prows, drows = rows_of("batch"), rows_of("decode_batch")
                logits, caches = T.forward_with_cache(params, {"tokens": toks[prows, :P]},
                                                      cfg, n)
                want = spec_parts(cfg, n)
                got = [logits.numpy()]
                shapes_ok = [want == L.tree_map(lambda t: tuple(t.shape), caches)]
                for i in range(D):
                    logits, caches = T.decode_step(params, toks[drows, P + i:P + i + 1],
                                                   caches, P + i, cfg, n)
                    got.append(logits.numpy())
                shapes_ok.append(want == L.tree_map(lambda t: tuple(t.shape), caches))
                seq_cut = L.cache_seq_cut(cfg, n)
            res[key] = {"logits": got, "rows": [(prows.start, prows.stop),
                                                (drows.start, drows.stop)],
                        "shapes_ok": all(shapes_ok),
                        "shapes": {p: tuple(t.shape) for p, t in _kv_paths(caches)},
                        "seq_cut": None if seq_cut is None else seq_cut.axes}
    np.save(out + f".{rank}.npy", res, allow_pickle=True)
    dist.destroy_process_group()
    """
)


def rows_of(logical: str) -> slice:
    """This rank's rows of ``ROWS`` over the mesh axes of ``logical`` under
    the active rules (a prefill's ``"batch"``, a decode's
    ``"decode_batch"``)."""
    cut = TS.batch_cut(logical)
    return slice(0, ROWS) if cut is None else cut.part(ROWS)


def spec_parts(cfg, length: int) -> dict:
    """Every cache leaf's shape as its spec cuts it under the active rules:
    the whole cache's shapes (``cache_shapes`` with no rules) divided along
    each dimension the spec (over ``cache_logical_axes``, the sequence's
    axis by ``kv_seq_axis``) cuts, a mamba2 state's ``"ssm_heads"`` too."""
    rules = TS.active_rules()
    with TS.use_rules(None):
        whole = TT.cache_shapes(cfg, ROWS, length)
    logical = TT.cache_logical_axes(cfg, TS.kv_seq_axis(cfg.n_kv_heads))

    def part(sd, lg):
        shape = sd[0]
        spec = rules.spec(lg, shape, record=False)
        return tuple(n // rules.size(TS._entry_axes(e)) for n, e in zip(shape, spec))

    def walk(s, lg):
        return {k: walk(s[k], lg[k]) for k in s} if isinstance(s, dict) else part(s, lg)

    return walk(whole, logical)


def qtensor_parts(rules) -> dict:
    """Every quantised leaf of ``PARTS_ARCHS``' smoke trees placed by
    ``tree_shardings`` over ``abstract_quantized``'s trees: whether this
    rank's dequantised part equals the whole's dequantised slice bit for
    bit (``shard`` of the dequantised whole by the payload's spec), whether
    ``unshard`` gives the payload and scale back bit for bit, and how many
    leaves are cut and whole, and how many parts narrow their scale.  A
    layer-stacked part split by ``unstack_layers`` and stacked again by
    ``stack_layers`` (``"stacked"`` counts them) dequantises to the whole's
    slices bit for bit; a narrowed part that has lost its ``start`` refuses
    to dequantise (``"refused"``)."""
    out = {"bitwise": True, "round_trip": True, "cut": 0, "whole": 0, "narrowed": 0,
           "stacked": 0, "refused": 0}
    for arch in PARTS_ARCHS:
        cfg = tget_config(arch).smoke()
        whole = port_weights(arch, True)
        qa, ql = TQ.abstract_quantized(TT.abstract_params(cfg), TT.logical_axes(cfg),
                                       TQ.default_lm_policy(cfg))
        specs = TS.tree_shardings(rules, qa, ql, record=False)
        parts = TS.shard_tree(whole, specs, rules, device="cpu")
        back = TS.unshard_tree(parts, specs, rules)
        triples = []
        TS.map_specs(lambda t, s: triples.append(s), whole, specs)
        for w, p, b, s in zip(tree_leaves(whole), tree_leaves(parts), tree_leaves(back),
                              triples):
            if not isinstance(w, TQ.QTensor):
                continue
            cut = bool(TS.spec_cuts(s.q, rules))
            out["cut" if cut else "whole"] += 1
            out["narrowed"] += int(p.local_scale().shape != p.scale.shape)
            want = TS.shard(w.dequantize(), s.q, rules, device="cpu")
            out["bitwise"] &= torch.equal(p.dequantize().view(torch.int32),
                                          want.view(torch.int32))
            out["round_trip"] &= torch.equal(b.q, w.q) and torch.equal(b.scale, w.scale)
            if cut and w.q.ndim >= 3 and p.q.shape[0] == w.scale.shape[0] == w.q.shape[0]:
                # a stack along a leading axis the part holds whole
                layers = unstack_layers(p, p.q.shape[0])
                again = stack_layers(layers)
                out["stacked"] += 1
                out["bitwise"] &= all(
                    torch.equal(layer.dequantize().view(torch.int32), want[i].view(torch.int32))
                    for i, layer in enumerate(layers))
                out["bitwise"] &= torch.equal(again.dequantize().view(torch.int32),
                                              want.view(torch.int32))
            if p.local_scale().shape != p.scale.shape:
                try:
                    TQ.QTensor(p.q, p.scale, p.axis).dequantize()
                except ValueError:
                    out["refused"] += 1
    return out


def _weights(tmp: Path) -> Path:
    path = tmp / "weights.npy"
    keys = {(a, False) for _, a, _, _, _ in CELLS.values()} | {(a, True) for a in INT8_ARCHS}
    np.save(path, {weights_key(a, q): TT.params_to_numpy(port_weights(a, q)) for a, q in keys},
            allow_pickle=True)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both references and the port's 4-rank world, run concurrently."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    data = _weights(tmp)
    refs = {m: subprocess.Popen([sys.executable, "-c", REFERENCE, m, str(data),
                                 str(tmp / f"ref_{m}.npy")], cwd=ROOT, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for m in MESHES}
    init = tmp / "rendezvous"
    ranks = [subprocess.Popen([sys.executable, "-c", PORT, str(r), "4", str(init), str(data),
                               str(tmp / "port")], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(4)]
    for proc in [*refs.values(), *ranks]:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
    ref = {}
    for m in MESHES:
        ref.update(np.load(tmp / f"ref_{m}.npy", allow_pickle=True).item())
    port = [np.load(tmp / f"port.{r}.npy", allow_pickle=True).item() for r in range(4)]
    return ref, port


@functools.lru_cache(maxsize=None)
def one_rank(arch, scenario, int8):
    """The port's 1-rank serving (no rules) of the same weights and tokens."""
    cfg = tget_config(arch).smoke()
    params = port_weights(arch, int8)
    L, P, D = SCENARIOS[scenario]
    toks = torch.from_numpy(serve_tokens(cfg.vocab, P + D))
    with torch.no_grad():
        logits, caches = TT.forward_with_cache(params, {"tokens": toks[:, :P]}, cfg, L)
        out = [logits.numpy()]
        for i in range(D):
            logits, caches = TT.decode_step(params, toks[:, P + i:P + i + 1], caches, P + i,
                                            cfg, L)
            out.append(logits.numpy())
    return out


#: logits against the reference's and the 1-rank run, relative to the
#: logits' scale (``tests/test_torch_lm_tp.py``'s serving limit)
SERVE_RTOL = 2e-4

IDS = list(CELLS)
CELL_PARAMS = pytest.mark.parametrize("cell", IDS, ids=[k.replace("/", "-") for k in IDS])


def _within(run: dict, want: list) -> list:
    """Each step's max |diff| over ``SERVE_RTOL`` times its scale, on this
    rank's rows (the prefill's, then each decode step's)."""
    (p0, p1), (d0, d1) = run["rows"]
    shares = []
    for i, (got, w) in enumerate(zip(run["logits"], want)):
        w = w[p0:p1] if i == 0 else w[d0:d1]
        assert got.shape == w.shape, (got.shape, w.shape)
        shares.append(float(np.abs(got - w).max() / (SERVE_RTOL * np.abs(w).max())))
    return shares


@CELL_PARAMS
def test_sharded_serving_matches_reference_gspmd(runs, cell):
    """Every rank's rows of the prefill's last logits and of each decode
    step's logits against the reference's GSPMD run on the same mesh."""
    ref, port = runs
    for r, run in enumerate(port):
        shares = _within(run[cell], ref[cell]["logits"])
        assert max(shares) <= 1, (r, shares)


@CELL_PARAMS
def test_sharded_serving_matches_port_one_rank(runs, cell):
    _, arch, scenario, _, int8 = CELLS[cell]
    for r, run in enumerate(runs[1]):
        shares = _within(run[cell], one_rank(arch, scenario, int8))
        assert max(shares) <= 1, (r, shares)


@CELL_PARAMS
def test_rank_caches_are_their_spec_parts(runs, cell):
    """On every rank, after the prefill and after the last decode step,
    every cache's shape is its spec's part; rank 0's attention caches have
    the shapes of the reference's shards on its first device; the sequence
    is cut where the rules cut it (a length of 30 stays whole at model = 4,
    as the reference keeps it)."""
    ref, port = runs
    mesh, arch, scenario, long, _ = CELLS[cell]
    assert all(run[cell]["shapes_ok"] for run in port)
    assert port[0][cell]["shapes"] == ref[cell]["shapes"]
    cfg = tget_config(arch).smoke()
    model = MESHES[mesh][1]
    cuts_seq = long or (cfg.n_kv_heads % model != 0 and SCENARIOS[scenario][0] % model == 0)
    assert (port[0][cell]["seq_cut"] is not None) == cuts_seq, port[0][cell]["seq_cut"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_qtensor_parts_are_the_whole_parts_bitwise(runs, mesh):
    """Each rank's dequantised int8 weights equal the whole weight's
    dequantised part bit for bit, for every quantised layout and through
    ``unstack_layers``/``stack_layers``, ``unshard(shard(q))`` is ``q``,
    payload and scale, bit for bit, and a part without its ``start``
    refuses to dequantise."""
    for run in runs[1]:
        parts = run[f"{mesh}/parts"]
        assert parts["bitwise"] and parts["round_trip"], parts
        assert parts["cut"] > 0 and parts["whole"] > 0 and parts["narrowed"] > 0, parts
        assert parts["stacked"] > 0 and parts["refused"] == parts["narrowed"], parts


@pytest.mark.parametrize("arch", lm_arch_names())
def test_quantized_tree_shardings_equal_reference(arch):
    """``tree_shardings`` over ``abstract_quantized``'s trees, payload and
    scale, leaf by leaf on the production meshes (16 x 16, 2 x 16 x 16),
    and the fallback log."""
    j, t = jget_config(arch), tget_config(arch)
    jtrees = JQ.abstract_quantized(JT.abstract_params(j), JT.logical_axes(j),
                                   JQ.default_lm_policy(j))
    ttrees = TQ.abstract_quantized(TT.abstract_params(t), TT.logical_axes(t),
                                   TQ.default_lm_policy(t))
    for shape in RULE_MESHES[:2]:
        jr, tr = JS.ShardingRules(_FakeMesh(shape)), TS.ShardingRules(_FakeMesh(shape))
        want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda lg, a: tuple(jr.spec(lg, dims=a.shape)), jtrees[1], jtrees[0],
            is_leaf=JS.is_logical_leaf), is_leaf=lambda v: isinstance(v, tuple))
        got = TS.tree_shardings(tr, *ttrees)
        flat = [x for leaf in tree_leaves(got)
                for x in ((leaf.q, leaf.scale) if isinstance(leaf, TQ.QTensor) else (leaf,))]
        assert [tuple(v) for v in flat] == want
        assert tr.fallbacks == jr.fallbacks
        assert any(isinstance(leaf, TQ.QTensor) for leaf in tree_leaves(got))


def test_cache_seq_cut_follows_the_rules():
    """The sequence's cut read from the cache's logical axes: over "model"
    where the kv heads do not divide it, never where they do (default
    rules); a length the axes do not divide stays whole; the long-context
    rules cut over "data" (and "data" x "model" for ``"kv_seq_model"``);
    an axis the rows took is dropped."""
    gemma, phi4 = tget_config("gemma-2b").smoke(), tget_config("phi4-mini-3.8b").smoke()

    def cut(cfg, length, shape, overrides=None):
        with TS.use_rules(TS.ShardingRules(_FakeMesh(shape), overrides)):
            c = TL.cache_seq_cut(cfg, length)
        return None if c is None else (c.axes, c.size)

    m4, m2 = {"data": 2, "model": 4}, {"data": 2, "model": 2}
    assert cut(gemma, 32, m4) == (("model",), 4)
    assert cut(gemma, 30, m4) is None and cut(gemma, 30, m2) == (("model",), 2)
    assert cut(phi4, 32, m2) is None and cut(phi4, 32, m4) == (("model",), 4)
    long = TS.LONG_CONTEXT_OVERRIDES
    assert cut(gemma, 32, m2, long) == (("data", "model"), 4)
    assert cut(phi4, 32, m2, long) == (("data",), 2)
    assert cut(gemma, 32, m4, {"decode_batch": ("model",)}) is None
    assert cut(gemma, 32, {"data": 1, "model": 1}) is None


def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports the standard
    library only)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: the dry run matrix's decode cells: (arch, shape, production mesh)
DECODE_CELLS = [(a, s, m) for a in tarch_names() for s in ("decode_32k", "long_500k")
                for m in (0, 1) if not skip_reason(tget_config(a), SHAPES[s])]


@pytest.mark.parametrize("arch,shape_name,mesh", DECODE_CELLS,
                         ids=[f"{a}-{s}-{('pod', 'multipod')[m]}" for a, s, m in DECODE_CELLS])
def test_decode_cell_arguments_follow_the_specs(arch, shape_name, mesh):
    """Every decode_32k and long_500k cell of the dry run's matrix, at both
    production meshes (long_500k under ``LONG_CONTEXT_OVERRIDES``, as
    ``run_cell`` takes it): the arguments ``build_cell`` makes, which
    ``trace_cell`` and the extrapolation record, built on fake tensors and
    not traced, hold exactly the bytes ``chip_smoke``'s reckoning from the
    specs gives (each param's and each cache's part of its spec, a mamba2
    state's heads over ``"ssm_heads"``), and no cache axis is left
    uncut."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, shape, mesh_shape = tget_config(arch), SHAPES[shape_name], RULE_MESHES[mesh]
    overrides = TS.LONG_CONTEXT_OVERRIDES if shape_name == "long_500k" else None
    rules = TS.ShardingRules(_FakeMesh(mesh_shape), overrides)
    with FakeTensorMode():
        _, args = DR.build_cell(cfg, shape, rules, 8, device="cpu")
        got = DR.StepMeter().track(args)
    want = _chip_smoke()._decode_arguments_from_specs(arch, shape_name, mesh_shape, overrides)
    assert got == want
    assert DR.uncut_cache_axes(cfg, shape, rules) == []
