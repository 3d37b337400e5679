"""The port's LM architectures against the JAX reference, all ten of them.

Weights are drawn once by the port (``init_params(seed, cfg, device="cpu")``),
carried to numpy by ``params_to_numpy`` and handed to both packages; token,
frame and patch inputs come from a seeded numpy generator.  Smoke configs
(``cfg.smoke()``, fp32), ``capacity_factor=16`` for the MoE archs so that no
token is dropped on either side.  Tolerances, and why:

* ``ATOL``/``RTOL`` 2e-4 on fp32 logits (scale 2-4) of the port against JAX:
  the products come from another BLAS (CPU ``torch.einsum`` against XLA's
  dot), each reduction in another order; measured at most 8.4e-5;
* 2e-4 (prefill) and 2e-3 (decode) for the port's own prefill/decode
  against its full forward, the reference's own test's bounds;
* quantisation, its scales and axes: bitwise (amax, a division and a round
  half to even are exact);
* bf16 (gemma-2b smoke): max ``BF16_ATOL`` 0.08 and mean ``BF16_MEAN``
  0.007 on logits of max ~2, mean |logit| ~0.4.  XLA's CPU evaluates bf16
  elementwise chains in fp32 and rounds where it fuses, PyTorch rounds
  after every op, so bf16's 2^-8 relative step (0.0078 at 1) compounds
  through the two layers' ~20 rounded ops; no bitwise or fp32-level claim
  is possible.  The limits sit between the sound port's reading (max
  0.0645, mean 0.00472) and those of a misplaced cast planted in a copy of
  the port: ``rmsnorm`` in bf16 reads 0.611 / 0.0213, RoPE's cos/sin left
  in fp32 0.254 / 0.0105, the softmax's exp in bf16 0.102 / 0.0052 (caught
  by the max alone).  Two faults do not show here and are held elsewhere:
  ``scale_embed``'s rounding of sqrt(d) (exact at the smoke width 64; see
  ``test_scale_embed_rounds_sqrt_d_like_reference``) and an exact-erf
  GELU (0.0625 / 0.00473 here; the fp32 logits tests catch it).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import lm_arch_names  # noqa: E402
from repro.configs.base import param_counts as jparam_counts  # noqa: E402
from repro.core.quantization import QTensor as JQTensor  # noqa: E402
from repro.models import quantized as jquant  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs import lm_arch_names as tlm_arch_names  # noqa: E402
from repro_torch.configs.base import param_counts as tparam_counts  # noqa: E402
from repro_torch.core.quantization import QTensor  # noqa: E402
from repro_torch.models import quantized as tquant  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

ARCHS = lm_arch_names()
DECODERS = [a for a in ARCHS if a != "hubert-xlarge"]
ATOL = RTOL = 2e-4
BF16_ATOL, BF16_MEAN = 0.08, 0.007
B, S, MAX = 2, 24, 40


def to_jax(np_tree, cfg):
    """A numpy params tree (``params_to_numpy``) as the reference's params."""
    specs = JT.build_specs(cfg)

    def leaf(a, spec):
        if isinstance(a, tuple):
            q, scale, axis = a
            return JQTensor(jnp.asarray(q), jnp.asarray(scale), axis)
        return jnp.asarray(a, jnp.dtype(spec.dtype or cfg.param_dtype))

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        return leaf(t, s)

    return walk(np_tree, specs)


def from_jax(tree):
    """The reference's params (``QTensor`` leaves too) as a numpy tree."""
    if isinstance(tree, dict):
        return {k: from_jax(v) for k, v in tree.items()}
    if isinstance(tree, JQTensor):
        return (np.asarray(tree.q), np.asarray(tree.scale), tree.axis)
    return np.asarray(tree.astype(jnp.float32))


def smoke(arch, **kw):
    kw = {"capacity_factor": 16.0, **kw}
    return jget_config(arch).smoke().replace(**kw), tget_config(arch).smoke().replace(**kw)


def inputs(cfg, seed=1, seq=S + 2):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal((B, seq, cfg.frontend_dim)).astype(np.float32)}
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        batch["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.frontend_dim)).astype(
            np.float32)
    return batch


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(reference cfg, port cfg, reference params, port params) of ``arch``."""
    jcfg, tcfg = smoke(arch)
    tp = TT.init_params(0, tcfg, device="cpu")
    return jcfg, tcfg, to_jax(TT.params_to_numpy(tp), jcfg), tp


@functools.lru_cache(maxsize=None)
def reference_run(arch):
    """The reference's full-sequence logits and, for decoders, its prefill
    and two decode steps' logits (numpy)."""
    jcfg, _, jp, _ = setup(arch)
    batch = inputs(jcfg)
    full = np.asarray(jax.jit(lambda p, b: JT.forward(p, b, jcfg))(jp, jb(batch)))
    if jcfg.is_encoder:
        return full, None
    pre = {k: (v[:, :S] if k == "tokens" else v) for k, v in batch.items()}
    last, caches = jax.jit(lambda p, b: JT.forward_with_cache(p, b, jcfg, MAX))(jp, jb(pre))
    steps = [np.asarray(last)]
    dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, t, c, pos, jcfg, MAX))
    off = jcfg.n_patches if jcfg.frontend == "vision_patches" else 0
    for i in range(2):
        tok = jnp.asarray(batch["tokens"][:, S + i : S + i + 1])
        lg, caches = dec(jp, tok, caches, jnp.asarray(S + i + off, jnp.int32))
        steps.append(np.asarray(lg))
    return full, steps


def port_prefill_decode(arch, tcfg, tp):
    batch = inputs(tcfg)
    pre = {k: (v[:, :S] if k == "tokens" else v) for k, v in batch.items()}
    last, caches = TT.forward_with_cache(tp, tb(pre), tcfg, MAX)
    steps = [last.numpy()]
    off = tcfg.n_patches if tcfg.frontend == "vision_patches" else 0
    for i in range(2):
        tok = torch.from_numpy(batch["tokens"][:, S + i : S + i + 1])
        lg, caches = TT.decode_step(tp, tok, caches, S + i + off, tcfg, MAX)
        steps.append(lg.numpy())
    return steps, off


# ---------------------------------------------------------------------------
# configs and parameter counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_by_field(arch):
    for smoke_it in (False, True):
        j, t = jget_config(arch), tget_config(arch)
        if smoke_it:
            j, t = j.smoke(), t.smoke()
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.n_groups, j.attends, j.subquadratic, j.is_encoder) == (
            t.n_groups, t.attends, t.subquadratic, t.is_encoder)


def test_registry_matches_reference():
    from repro.configs import ALIASES as JALIASES
    from repro.configs import ARCHS as JARCHS
    from repro_torch.configs import ALIASES as TALIASES

    assert TARCHS == JARCHS and TALIASES == JALIASES
    assert tlm_arch_names() == ARCHS
    assert dataclasses.asdict(tget_config("shield8-cnn")) == dataclasses.asdict(
        jget_config("shield8-cnn"))


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_param_counts_equal_reference(arch):
    """The full published config: the same spec tree (shapes, logical axes,
    init, dtype) and the same counts, from specs, nothing allocated."""
    j, t = jget_config(arch), tget_config(arch)
    jspecs = jax.tree_util.tree_leaves_with_path(
        JT.build_specs(j), is_leaf=lambda s: hasattr(s, "logical"))
    tspecs = tree_leaves(TT.build_specs(t))
    assert [tuple(s) for _, s in jspecs] == [tuple(s) for s in tspecs]
    assert TT.param_count(t) == JT.param_count(j)
    assert TT.active_param_count(t) == JT.active_param_count(j)
    try:
        want = jparam_counts(j)
    except KeyError:  # the reference's analytic count knows no mamba2_shared
        with pytest.raises(KeyError):
            tparam_counts(t)
    else:
        assert tparam_counts(t) == want


def test_gemma_2b_published_parameter_count():
    assert TT.param_count(tget_config("gemma-2b")) == 2_506_172_416


# ---------------------------------------------------------------------------
# forward, prefill and decode against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jcfg, tcfg, _, tp = setup(arch)
    full, _ = reference_run(arch)
    got = TT.forward(tp, tb(inputs(tcfg)), tcfg).numpy()
    assert got.shape == full.shape == (B, S + 2 + (tcfg.n_patches or 0), tcfg.vocab)
    np.testing.assert_allclose(got, full, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_match_reference(arch):
    _, tcfg, _, tp = setup(arch)
    _, ref_steps = reference_run(arch)
    steps, _ = port_prefill_decode(arch, tcfg, tp)
    for got, want in zip(steps, ref_steps):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_decode_matches_own_forward(arch):
    """The twin of ``test_lm_archs.py::test_prefill_decode_matches_forward``."""
    _, tcfg, _, tp = setup(arch)
    full = TT.forward(tp, tb(inputs(tcfg)), tcfg).numpy()
    steps, off = port_prefill_decode(arch, tcfg, tp)
    np.testing.assert_allclose(steps[0][:, 0], full[:, S - 1 + off], rtol=2e-4, atol=2e-4)
    for i in range(2):
        np.testing.assert_allclose(steps[1 + i][:, 0], full[:, S + i + off], rtol=2e-3, atol=2e-3)


def test_encoder_forward_is_bidirectional():
    """hubert is an encoder: position 0's logits depend on later frames."""
    _, tcfg, _, tp = setup("hubert-xlarge")
    batch = inputs(tcfg)
    a = TT.forward(tp, tb(batch), tcfg)
    batch["frames"][:, -1] += 1.0
    b = TT.forward(tp, tb(batch), tcfg)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 0


def test_ring_cache_matches_full_window_and_reference():
    """Sliding-window decode with a ring cache == full forward beyond the
    window (the twin of ``test_ring_cache_matches_full_window``), and the
    ring's layout == the reference's."""
    jcfg, tcfg = smoke("h2o-danube-3-4b", window=8)
    tp = TT.init_params(0, tcfg, device="cpu")
    jp = to_jax(TT.params_to_numpy(tp), jcfg)
    tok = np.random.default_rng(3).integers(0, tcfg.vocab, (1, 24)).astype(np.int32)
    full = TT.forward(tp, {"tokens": torch.from_numpy(tok)}, tcfg).numpy()
    _, caches = TT.forward_with_cache(tp, {"tokens": torch.from_numpy(tok[:, :20])}, tcfg, 24)
    _, jcaches = JT.forward_with_cache(jp, {"tokens": jnp.asarray(tok[:, :20])}, jcfg, 24)
    k0 = tree_leaves(caches)[0]
    assert k0.shape[2] == 8  # ring buffer length == window
    for got, want in zip(tree_leaves(caches), jax.tree_util.tree_leaves(jcaches)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    for i in range(4):
        lg, caches = TT.decode_step(tp, torch.from_numpy(tok[:, 20 + i : 21 + i]), caches,
                                    20 + i, tcfg, 24)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, 20 + i], rtol=2e-3, atol=2e-3)


def test_scan_equals_unroll():
    _, tcfg, _, tp = setup("gemma-2b")
    batch = tb(inputs(tcfg))
    a = TT.forward(tp, batch, tcfg.replace(stack_mode="scan"))
    b = TT.forward(tp, batch, tcfg.replace(stack_mode="unroll"))
    assert torch.equal(a, b)


def test_zamba2_shared_block_is_shared():
    _, tcfg, _, tp = setup("zamba2-7b")
    assert "shared" in tp
    # zero the shared weights -> every shared block changes
    z = tree_map(torch.zeros_like, tp["shared"])
    batch = tb(inputs(tcfg))
    base = TT.forward(tp, batch, tcfg)
    changed = TT.forward({**tp, "shared": z}, batch, tcfg)
    assert float((base - changed).abs().max()) > 1e-3


def test_params_round_trip_through_numpy():
    _, tcfg, _, tp = setup("olmoe-1b-7b")
    qp = tquant.quantize_lm_params(tp, cfg=tcfg)
    back = TT.params_from_numpy(TT.params_to_numpy(qp), tcfg)
    for a, b in zip(tree_leaves(qp), tree_leaves(back)):
        if isinstance(a, QTensor):
            assert a.axis == b.axis
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_cache_shapes_equal_reference():
    for arch in DECODERS:
        jcfg, tcfg = smoke(arch)
        want = jax.tree_util.tree_leaves(JT.cache_shapes(jcfg, 3, 40))
        got = tree_leaves(TT.cache_shapes(tcfg, 3, 40))
        assert [tuple(s.shape) for s in want] == [tuple(s[0]) for s in got], arch


# ---------------------------------------------------------------------------
# quantisation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma-2b", "olmoe-1b-7b", "rwkv6-7b", "zamba2-7b"])
def test_quantize_lm_params_bitwise_reference(arch):
    jcfg, tcfg, jp, tp = setup(arch)
    jq = from_jax(jquant.quantize_lm_params(jp, jquant.default_lm_policy(jcfg)))
    tq = TT.params_to_numpy(tquant.quantize_lm_params(tp, tquant.default_lm_policy(tcfg)))
    n_q = 0

    def walk(a, b, path):
        nonlocal n_q
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, tuple):
            assert isinstance(b, tuple), path
            n_q += 1
            assert a[2] == b[2], path
            for x, y in zip(a[:2], b[:2]):
                assert x.shape == y.shape and x.dtype == y.dtype, path
                np.testing.assert_array_equal(x, y, err_msg=path)
        else:
            assert not isinstance(b, tuple), path
            np.testing.assert_array_equal(a, b, err_msg=path)

    walk(jq, tq, "")
    assert n_q > 0
    tqp = tquant.quantize_lm_params(tp, cfg=tcfg)
    assert tquant.quantized_fraction(tqp) == pytest.approx(
        jquant.quantized_fraction(to_jax(tq, jcfg)), rel=1e-12)


def test_olmoe_keeps_per_layer_head_lane_scales():
    """ROADMAP's M10 gate: olmoe's stacked q/k/v carry one scale per
    (layer, head, lane), ``scale`` (G, 1, H, Dh), and a group's slice
    takes its own scales."""
    _, tcfg, _, tp = setup("olmoe-1b-7b")
    qp = tquant.quantize_lm_params(tp, cfg=tcfg)
    attn = qp["groups"]["pos0"]["attn"]
    g, h, kv, dh = tcfg.n_groups, tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim
    assert tuple(attn["wq"].scale.shape) == (g, 1, h, dh)
    assert tuple(attn["wk"].scale.shape) == (g, 1, kv, dh)
    assert tuple(attn["wo"].scale.shape) == (g, 1, 1, tcfg.d_model)
    moe = qp["groups"]["pos0"]["moe"]
    assert tuple(moe["wi_gate"].scale.shape) == (g, 1, 1, tcfg.d_ff)
    grp = TT._group(qp["groups"], 1)["pos0"]["attn"]["wq"]
    assert torch.equal(grp.scale, attn["wq"].scale[1])
    assert torch.equal(grp.q, attn["wq"].q[1])


@pytest.mark.parametrize("arch", ["gemma-2b", "olmoe-1b-7b", "zamba2-7b"])
def test_quantized_forward_matches_reference(arch):
    """Weight-only int8 through ``qeinsum`` (dequantised into fp32)."""
    jcfg, tcfg, jp, tp = setup(arch)
    jq = jquant.quantize_lm_params(jp, jquant.default_lm_policy(jcfg))
    tq = tquant.quantize_lm_params(tp, tquant.default_lm_policy(tcfg))
    batch = inputs(tcfg)
    want = np.asarray(jax.jit(lambda p, b: JT.forward(p, b, jcfg))(jq, jb(batch)))
    got = TT.forward(tq, tb(batch), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bf16_smoke_within_stated_tolerance():
    """gemma-2b's smoke config in bf16 params and activations."""
    jcfg, tcfg = smoke("gemma-2b", param_dtype="bfloat16", act_dtype="bfloat16")
    tp = TT.init_params(0, tcfg, device="cpu")
    assert tp["groups"]["pos0"]["attn"]["wq"].dtype == torch.bfloat16
    jp = to_jax(TT.params_to_numpy(tp), jcfg)
    batch = inputs(tcfg)
    want = np.asarray(jax.jit(lambda p, b: JT.forward(p, b, jcfg))(jp, jb(batch)))
    got = TT.forward(tp, tb(batch), tcfg).numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
    assert np.abs(got - want).mean() <= BF16_MEAN


def test_scale_embed_rounds_sqrt_d_like_reference():
    """bf16 at a width whose square root is no bf16 number (48): each side
    multiplies the gathered rows once by sqrt(d) rounded to bf16, so the
    embeddings agree bitwise."""
    jcfg, tcfg = smoke("gemma-2b", param_dtype="bfloat16", act_dtype="bfloat16", d_model=48)
    tp = TT.init_params(0, tcfg, device="cpu")
    jp = to_jax(TT.params_to_numpy(tp), jcfg)
    batch = inputs(tcfg)
    want = np.asarray(JT.embed_fwd(jp, jb(batch), jcfg).astype(jnp.float32))
    got = TT.embed_fwd(tp, tb(batch), tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
