"""The port's dry run (``launch/dryrun.py``), collective accounting
(``launch/comm_analysis.py``) and roofline (``launch/roofline.py``) on the CPU.

* The five cells of ``tests/test_dryrun_small.py`` (gemma-2b and olmoe
  train; rwkv6, zamba2 and gemma3 decode; smoke configs, fp32, 8 rows of 64
  positions) traced on a fake ("pod", "data", "model") = (2, 2, 2) mesh in
  a subprocess (a process has one default process group, and none may leak
  into the test process), with olmoe once more with its a2a MoE and
  vocab-parallel gather turned on.
* gemma-2b's FLOPs equal a hand count of its step's matmuls exactly, each
  product cut over the model axis (2 ranks) taking its part.
* Every cell's collectives equal a hand count: the data-parallel step's
  (one all-reduce per gradient leaf, of this rank's part of it, one for
  the loss and one label count per microbatch over the batch group of 4
  ranks), and the tensor-parallel ones over "model" (2 ranks): the
  embedding's masked sum, attention's and the MLP's ``copy_to`` (backward)
  and ``reduce_from`` (forward), the unembedding's ``copy_to``, the
  vocab-parallel cross entropy's three all-reduces, the clip's norm; the
  dense MoE's ``copy_to`` of its tokens and router, its combine, and its
  global-capacity count all-gather over the batch group; with a2a its
  all-to-alls and all-gathers; in decode, the forward's all-reduces and
  all-gathers (RWKV's gate, the logits; mamba2's projection gathered, its
  norm's sums of squares and ``w_out`` reduced, as its heads are cut).
* FLOPs within ``XLA_FACTOR`` of the reference's ``cost_analysis()`` for
  the same smoke cells, unrolled, at ``n_micro=1`` on one device: XLA also
  counts elementwise FLOPs, which ``FlopCounterMode`` does not (measured:
  0.827 for zamba2's decode to 0.966 for gemma3's, of XLA's).

The extrapolated cells, the meter, the driver and the roofline:
``tests/test_torch_dryrun_driver.py``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
XLA_FACTOR = (0.80, 1.0)
CELLS = [("gemma-2b", "train", {}), ("olmoe-1b-7b", "train", {}),
         ("olmoe-1b-7b", "train", {"moe_impl": "a2a", "sharded_embed_gather": True}),
         ("rwkv6-7b", "decode", {}), ("zamba2-7b", "decode", {}), ("gemma3-12b", "decode", {}),
         ("gemma-2b", "decode", {"n_kv_heads": 1})]
#: the decode cell whose caches' sequence is cut: one kv head, which the
#: model axis of 2 does not divide ("kv_seq_model")
SEQ_CUT_CELL = ("gemma-2b", "decode", {"n_kv_heads": 1})
N_MICRO = 2
ROWS, SEQ = 8, 64

SCRIPT = textwrap.dedent("""\
    import json, sys
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.specs import ShapeSpec

    D.fake_world(8)
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    out = []
    for arch, kind, extra in json.loads(sys.argv[1]):
        cfg = get_config(arch).smoke().replace(**{{"n_kv_heads": 4, "param_dtype": "float32",
                                                  "act_dtype": "float32", **extra}})
        rec = D.trace_cell(cfg, ShapeSpec("t", {seq}, {rows}, kind), ShardingRules(mesh),
                           {n_micro}, device="cpu")
        out.append(rec)
    print("RESULT:" + json.dumps(out))
    """).format(seq=SEQ, rows=ROWS, n_micro=N_MICRO)


@pytest.fixture(scope="module")
def records():
    proc = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(CELLS)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT:")][-1]
    return json.loads(line[len("RESULT:"):])


def smoke(arch, **extra):
    from repro_torch.configs import get_config

    return get_config(arch).smoke().replace(**{"n_kv_heads": 4, "param_dtype": "float32",
                                               "act_dtype": "float32", **extra})


def leaf_bytes(cfg) -> list[int]:
    """Each gradient leaf's fp32 bytes on one rank: its part of its spec on
    the (2, 2, 2) mesh (a cut dimension halves)."""
    from repro_torch.distributed import sharding as TS
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_leaves

    rules = TS.ShardingRules(_Mesh())
    specs = TS.tree_shardings(rules, T.abstract_params(cfg), T.logical_axes(cfg))
    out = []
    for t, spec in zip(tree_leaves(T.abstract_params(cfg)),
                       tree_leaves(TS.map_specs(lambda _, sp: [sp], T.abstract_params(cfg),
                                                specs))):
        n = t.numel()
        for entry in spec[0]:
            n //= 2 if entry == "model" else 1  # "pod"/"data" never cut a param
        out.append(n * 4)
    return out


class _Mesh:
    axis_names, shape = ("pod", "data", "model"), {"pod": 2, "data": 2, "model": 2}


def expected(arch, kind, extra) -> dict:
    """The cell's collectives by hand: ``{"group_sizes", "per_op_bytes",
    "by_dtype"}`` (comm_analysis's conventions: an all-reduce counts twice
    its bytes, an all-gather its result)."""
    cfg = smoke(arch, **extra)
    d, e, v, L = cfg.d_model, cfg.n_experts, cfg.vocab, cfg.n_layers
    groups: dict = {}
    nbytes: dict = {}
    dtypes: dict = {}

    def add(op, group, count, each, dtype="f32"):
        factor = 2.0 if op == "all-reduce" else 1.0
        g = groups.setdefault(op, {})
        g[str(group)] = g.get(str(group), 0) + count
        nbytes[op] = nbytes.get(op, 0.0) + factor * count * each
        dtypes[dtype] = dtypes.get(dtype, 0.0) + factor * count * each

    if kind == "decode":
        rows = ROWS // 4
        act, logits = rows * d * 4, rows * v * 4
        add("all-reduce", 2, 1, act)  # the embedding's masked sum
        add("all-gather", 2, 1, logits)  # the whole logits
        if arch == "rwkv6-7b":  # time mix's wo, channel mix's cv; the gate cr
            add("all-reduce", 2, 2 * L, act)
            add("all-gather", 2, L, act)
        elif arch == "zamba2-7b":  # every mamba2 block, head-parallel (a decode's few
            d_in = cfg.ssm_expand * d  # tokens take the activation route): the
            nh, n = d_in // cfg.ssm_head_dim, cfg.ssm_state  # projection's gather,
            add("all-gather", 2, L, rows * (2 * d_in + 2 * n + nh) * 4)
            add("all-reduce", 2, L, rows * 4)  # out_norm's sums of squares,
            add("all-reduce", 2, L, act)  # w_out's reduce_from
            add("all-reduce", 2, 2 * cfg.n_groups, act)  # the shared attention and MLP
        else:  # attention's wo and the MLP's wo, every layer
            add("all-reduce", 2, 2 * L, act)
        if cfg.n_kv_heads % 2:  # ring-decode attention over the cut sequence, every layer:
            h, dh = cfg.n_heads, cfg.head_dim
            add("all-gather", 2, L, rows * h * dh * 4)  # the query heads
            add("all-reduce", 2, L, rows * h * 4)  # the partial max
            add("all-reduce", 2, L, rows * h * (dh + 1) * 4)  # the sums and accumulators
        return {"group_sizes": groups, "per_op_bytes": nbytes, "by_dtype": dtypes}

    leaves = leaf_bytes(cfg)
    add("all-reduce", 4, len(leaves), sum(leaves) / len(leaves))  # gradient sums
    add("all-reduce", 4, 1, 4)  # the loss
    add("all-reduce", 4, N_MICRO, 8, "s64")  # the label counts
    t = ROWS // 4 // N_MICRO * SEQ  # a micro's tokens on a rank
    act = t * d * 4
    per_micro = {"act": 1 + 1, "tok": 3, "router": 0}  # embedding, unembedding; the CE's
    per_micro["act"] += 2 * L  # attention: copy_to, reduce_from
    if "moe" in cfg.pattern and extra.get("moe_impl") == "a2a":
        t_loc = SEQ * 4 // 8  # the global tokens of a micro over 4 batch x 2 model shards
        cap = max(8, -(-int(t_loc * cfg.top_k / e * cfg.capacity_factor) // 8) * 8)
        per_micro["act"] += L  # the tokens' copy_to
        per_micro["router"] = L
        add("all-to-all", 2, 4 * N_MICRO * L, e * cap * d * 4)
        add("all-gather", 2, N_MICRO * L, 2 * t_loc * d * 4)
    elif "moe" in cfg.pattern:
        per_micro["act"] += 2 * L  # the tokens' copy_to, the combine's reduce_from
        per_micro["router"] = L
        add("all-gather", 4, N_MICRO * L, 4 * e * 4, "s32")  # the experts' counts
    else:
        per_micro["act"] += 2 * L  # the MLP's copy_to, reduce_from
    add("all-reduce", 2, N_MICRO * per_micro["act"], act)
    add("all-reduce", 2, N_MICRO * per_micro["tok"], t * 4)
    add("all-reduce", 2, N_MICRO * per_micro["router"], d * e * 4)
    add("all-reduce", 2, 1, 4)  # the clip's norm: the cut leaves' squares
    groups = {op: {g: c for g, c in gs.items() if c} for op, gs in groups.items()}
    return {"group_sizes": groups, "per_op_bytes": nbytes, "by_dtype": dtypes}


@pytest.mark.parametrize("i", range(len(CELLS)), ids=[
    f"{a}-{k}{'-a2a' if 'moe_impl' in e else '-kv1' if e else ''}" for a, k, e in CELLS])
def test_smoke_cell_traces_on_a_fake_2x2x2_mesh(records, i):
    arch, kind, extra = CELLS[i]
    rec = records[i]
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["rows_per_device"] == ROWS // 4  # the batch over ("pod", "data")
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] < mem["peak_bytes"]
    coll, want = rec["collectives"], expected(arch, kind, extra)
    assert coll["group_sizes"] == want["group_sizes"]
    assert coll["per_op_bytes"] == pytest.approx(want["per_op_bytes"], rel=1e-12)
    assert coll["by_dtype"] == pytest.approx(want["by_dtype"], rel=1e-12)
    assert coll["counts"] == {op: sum(g.values()) for op, g in want["group_sizes"].items()}


def test_gemma_train_flops_equal_a_hand_count(records):
    cfg = smoke("gemma-2b")
    m = 2  # the model axis: heads, kv heads, the MLP and the vocab all cut
    b, s = ROWS // 4 // N_MICRO, SEQ
    d, h, kv, dh, ff, v = (cfg.d_model, cfg.n_heads // m, cfg.n_kv_heads // m, cfg.head_dim,
                           cfg.d_ff // m, cfg.vocab // m)
    layer = (2 * b * s * d * (h + 2 * kv) * dh  # q, k, v
             + 2 * b * s * h * dh * d  # o
             + 2 * 2 * b * h * s * s * dh  # scores, weights x values
             + 3 * 2 * b * s * d * ff)  # GeGLU: gate, up, down
    forward = cfg.n_layers * layer + 2 * b * s * d * v  # tied unembedding
    assert cfg.tie_embeddings and not cfg.remat and cfg.mlp_kind == "geglu"
    # backward: both operands of every matmul take a gradient (2x forward)
    assert records[0]["flops_per_device"] == 3 * forward * N_MICRO


def test_gemma_2b_arguments_at_pod_16x16_follow_the_specs():
    """gemma-2b's train_4k arguments on ``pod_16x16``: 0.316 B of its 2.506
    B parameters a rank (the vocab and the MLP cut 16 ways; its 8 heads
    and one kv head do not divide 16, so attention is whole), bf16, with
    fp32 mu and nu, Adam's step and the rank's 16 rows of 4,096 tokens and
    labels, each storage in 512-byte blocks, as the dry run builds them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.specs import SHAPES

    class Pod:
        axis_names, shape = ("data", "model"), {"data": 16, "model": 16}

    cfg = get_config("gemma-2b")
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    attn = 2 * d * cfg.n_heads * cfg.head_dim + 2 * d * cfg.n_kv_heads * cfg.head_dim
    leaves = [v // 16 * d, d]  # the table, the final norm
    leaves += [L * d] * 2 + [L * d * cfg.n_heads * cfg.head_dim] * 2  # norms, wq, wo
    leaves += [L * d * cfg.n_kv_heads * cfg.head_dim] * 2  # wk, wv
    leaves += [L * d * f // 16] * 3  # wi_gate, wi_up, wo
    n = sum(leaves)
    assert n == v // 16 * d + d + L * (2 * d + attn + 3 * d * f // 16) == 315_959_296
    assert round(n / 1e9, 3) == 0.316 and round(2_506_172_416 / 1e9, 3) == 2.506
    norms = {d, L * d}  # fp32 leaves (the rest bf16)
    block = lambda nb: -(-nb // 512) * 512  # noqa: E731
    params = sum(block(x * (4 if x in norms else 2)) for x in leaves)
    adam = 2 * sum(block(x * 4) for x in leaves) + block(4)
    batch = 2 * block(256 // 16 * 4096 * 4)
    with FakeTensorMode():
        _, args = D.build_cell(cfg, SHAPES["train_4k"], ShardingRules(Pod()), 8, device="cpu")
        got = D.StepMeter().track(args)
    assert got == params + adam + batch


def test_kv_seq_model_decode_cell_arguments_follow_the_specs(records):
    """gemma-2b with one kv head decoding on the (2, 2, 2) mesh: the model
    axis does not divide its kv heads, so its caches' sequence is cut over
    "model" (``"kv_seq_model"``), and a rank's arguments are, reckoned from
    the specs, its params' parts, its rows' tokens, and its half of every
    cache's positions, each storage in 512-byte blocks."""
    i = CELLS.index(SEQ_CUT_CELL)
    cfg = smoke("gemma-2b", **SEQ_CUT_CELL[2])
    block = lambda nb: -(-nb // 512) * 512  # noqa: E731
    rows = ROWS // 4
    cache = cfg.n_groups * rows * (SEQ // 2) * cfg.n_kv_heads * cfg.head_dim * 4
    want = (sum(block(b) for b in leaf_bytes(cfg)) + block(rows * 4)
            + 2 * len(cfg.pattern) * block(cache))
    assert records[i]["memory"]["argument_bytes"] == want
    assert records[i]["rows_per_device"] == rows


def test_flops_within_a_factor_of_xla_cost_analysis():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.launch.specs import ShapeSpec as JShape
    from repro.launch.specs import batch_specs, cache_specs
    from repro.models import transformer as JT
    from repro.training.lm import TrainSettings, make_decode_step, make_train_step
    from repro.training.optimizer import Adam, AdamState
    from repro_torch.distributed.sharding import HostMesh, ShardingRules
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.specs import ShapeSpec

    rules = ShardingRules(HostMesh(("data", "model")))
    for arch, kind, extra in CELLS:
        if extra:
            continue
        jcfg = jget(arch).smoke().replace(n_kv_heads=4, param_dtype="float32",
                                          act_dtype="float32", stack_mode="unroll",
                                          unroll_attn=True, remat=False)
        ap = JT.abstract_params(jcfg)
        shape = JShape("t", SEQ, ROWS, kind)
        if kind == "train":
            mom = lambda: jax.tree_util.tree_map(  # noqa: E731
                lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32), ap)
            ost = AdamState(step=jax.ShapeDtypeStruct((), jnp.int32), mu=mom(), nu=mom())
            fn = make_train_step(jcfg, Adam(lr=1e-4), TrainSettings(n_micro=1))
            compiled = jax.jit(fn).lower(ap, ost, batch_specs(jcfg, shape)[0]).compile()
        else:
            ac, _ = cache_specs(jcfg, shape, model_axis_size=1)
            compiled = jax.jit(make_decode_step(jcfg, max_seq=SEQ)).lower(
                ap, jax.ShapeDtypeStruct((ROWS, 1), jnp.int32), ac,
                jax.ShapeDtypeStruct((), jnp.int32)).compile()
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        rec = D.trace_cell(smoke(arch), ShapeSpec("t", SEQ, ROWS, kind), rules, 1, device="cpu")
        ratio = rec["flops_per_device"] / ca["flops"]
        assert XLA_FACTOR[0] <= ratio <= XLA_FACTOR[1], (arch, kind, ratio)
