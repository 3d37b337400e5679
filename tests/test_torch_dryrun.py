"""The port's dry run (``launch/dryrun.py``), collective accounting
(``launch/comm_analysis.py``) and roofline (``launch/roofline.py``) on the CPU.

* The five cells of ``tests/test_dryrun_small.py`` (gemma-2b and olmoe
  train; rwkv6, zamba2 and gemma3 decode; smoke configs, fp32, 8 rows of 64
  positions) traced on a fake ("pod", "data", "model") = (2, 2, 2) mesh in
  a subprocess (a process has one default process group, and none may leak
  into the test process), with olmoe once more with its a2a MoE and
  vocab-parallel gather turned on.
* gemma-2b's FLOPs equal a hand count of its step's matmuls exactly.
* Every cell's collectives equal what the data-parallel step issues: one
  all-reduce per gradient leaf, one for the loss and one label count per
  microbatch over the batch group (4 ranks); with a2a and the gather, their
  all-to-alls, all-gathers and "model"-axis all-reduces, counts and bytes.
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
         ("rwkv6-7b", "decode", {}), ("zamba2-7b", "decode", {}), ("gemma3-12b", "decode", {})]
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
        cfg = get_config(arch).smoke().replace(n_kv_heads=4, param_dtype="float32",
                                               act_dtype="float32", **extra)
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

    return get_config(arch).smoke().replace(n_kv_heads=4, param_dtype="float32",
                                            act_dtype="float32", **extra)


def leaf_bytes(cfg) -> list[int]:
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_leaves

    return [t.numel() * 4 for t in tree_leaves(T.abstract_params(cfg))]  # fp32 gsum


@pytest.mark.parametrize("i", range(len(CELLS)), ids=[f"{a}-{k}{'-a2a' if e else ''}"
                                                      for a, k, e in CELLS])
def test_smoke_cell_traces_on_a_fake_2x2x2_mesh(records, i):
    arch, kind, extra = CELLS[i]
    rec = records[i]
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["rows_per_device"] == ROWS // 4  # the batch over ("pod", "data")
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] < mem["peak_bytes"]
    coll = rec["collectives"]
    if kind == "decode":
        assert coll["counts"] == {} and coll["total_bytes"] == 0
        return
    leaves = leaf_bytes(smoke(arch, **extra))
    dp = len(leaves) + 1 + N_MICRO  # gradient sums, the loss, the label counts
    dp_bytes = 2.0 * (sum(leaves) + 4 + 8 * N_MICRO)  # all-reduce: twice its bytes
    if not extra:
        assert coll["counts"] == {"all-reduce": dp}
        assert coll["group_sizes"] == {"all-reduce": {"4": dp}}
        assert coll["per_op_bytes"] == {"all-reduce": dp_bytes}
        assert coll["by_dtype"] == {"f32": 2.0 * (sum(leaves) + 4), "s64": 16.0 * N_MICRO}
        return
    # a2a MoE and vocab-parallel gather over "model" (2 ranks), a micro of
    # 1 row x 64 positions: per layer five copy_to all-reduces (normed
    # tokens, router, three expert weights) in the backward, two
    # all-to-alls each way, one all-gather; the gather's copy_to and
    # reduce_from once a micro
    cfg = smoke(arch, **extra)
    e, k, d, f = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff
    t_loc = SEQ * 4 // 8  # the global tokens of a micro over 4 batch x 2 model shards
    cap = max(8, -(-int(t_loc * k / e * cfg.capacity_factor) // 8) * 8)
    n = N_MICRO * cfg.n_layers
    model_ar = (t_loc * 2 * d + d * e + 3 * e * d * f) * 4  # h, router, experts: fp32
    gather_ar = (cfg.vocab * d + SEQ * d) * 4  # the table's gradient, reduce_from
    assert coll["group_sizes"] == {"all-reduce": {"4": dp, "2": 5 * n + 2 * N_MICRO},
                                   "all-to-all": {"2": 4 * n}, "all-gather": {"2": n}}
    assert coll["per_op_bytes"] == {
        "all-reduce": dp_bytes + 2.0 * (n * model_ar + N_MICRO * gather_ar),
        "all-to-all": 4.0 * n * e * cap * d * 4,
        "all-gather": 1.0 * n * 2 * t_loc * d * 4}


def test_gemma_train_flops_equal_a_hand_count(records):
    cfg = smoke("gemma-2b")
    b, s = ROWS // 4 // N_MICRO, SEQ
    d, h, kv, dh, ff, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                           cfg.vocab)
    layer = (2 * b * s * d * (h + 2 * kv) * dh  # q, k, v
             + 2 * b * s * h * dh * d  # o
             + 2 * 2 * b * h * s * s * dh  # scores, weights x values
             + 3 * 2 * b * s * d * ff)  # GeGLU: gate, up, down
    forward = cfg.n_layers * layer + 2 * b * s * d * v  # tied unembedding
    assert cfg.tie_embeddings and not cfg.remat and cfg.mlp_kind == "geglu"
    # backward: both operands of every matmul take a gradient (2x forward)
    assert records[0]["flops_per_device"] == 3 * forward * N_MICRO


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
