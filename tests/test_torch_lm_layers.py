"""The port's LM building blocks against the JAX reference, one at a time.

Inputs come from a seeded numpy generator (weights from the port's
``init_from_specs`` on a CPU generator, carried to JAX as numpy) and go
through the reference function and its counterpart.  Tolerances, and why:

* ``ATOL`` 1e-5 on fp32 block outputs of scale ~1-5: the einsums come from
  another BLAS and reduce in another order (measured at most ~4e-6);
* 1e-6 on ``rmsnorm`` and ``rope`` (elementwise, one fp32 reduction);
* bitwise: ``int8_symmetric_keep``, ``prune_ffn``'s kept indices and
  slices, the MoE routing and capacity slots, and
  ``policy_einsum(use_kernel=True)``, which runs the W8A8 matmul on both
  sides (the reference's Pallas kernel in interpret mode).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.core import precision_policy as jpp  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.core import quantization as jq  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import precision_policy as tpp  # noqa: E402
from repro_torch.core import pruning as tpruning  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.kernels import quant_matmul as tqmm  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

torch.set_num_threads(1)

ATOL = RTOL = 1e-5


def cfgs(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
                head_dim=8, d_ff=48, vocab=64, param_dtype="float32", act_dtype="float32",
                remat=False)
    base.update(kw)
    return JArchConfig(**base), ArchConfig(**base)


def params(specs_fn, jcfg, tcfg, seed=0):
    """The port's init of ``specs_fn(cfg)`` and the same values for JAX."""
    tp = TL.init_from_specs(torch.Generator().manual_seed(seed), specs_fn(tcfg), tcfg)

    def to_jax(t):
        if isinstance(t, dict):
            return {k: to_jax(v) for k, v in t.items()}
        return jnp.asarray(t.numpy())

    return to_jax(tp), tp


def rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# norms, RoPE, qeinsum
# ---------------------------------------------------------------------------


def test_rmsnorm_matches_reference():
    x = rand((2, 5, 48)) * 3
    scale = rand((48,), 1)
    got = TL.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-5)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    close(got, want, 1e-6, 1e-6)


@pytest.mark.parametrize("head_dim", [16, 15])
def test_rope_matches_reference(head_dim):
    """Odd head_dim: the last lane passes through unrotated."""
    x = rand((2, 7, 3, head_dim))
    pos = np.arange(7)[None, :] + 100
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    close(got, want, 1e-6, 1e-6)
    if head_dim % 2:
        assert torch.equal(got[..., -1], torch.from_numpy(x[..., -1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qeinsum_dequantises_like_reference(dtype):
    w = rand((16, 12), 1)
    x = rand((2, 3, 16))
    jqt = jq.int8_symmetric(jnp.asarray(w), axis=1)
    tqt = tq.int8_symmetric(torch.from_numpy(w), axis=1)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(TL.torch_dtype(dtype))
    want = JL.qeinsum("bsd,dn->bsn", jx, jqt).astype(jnp.float32)
    got = TL.qeinsum("bsd,dn->bsn", tx, tqt).to(torch.float32)
    # the dequantised weight is bitwise the reference's in either dtype
    assert np.array_equal(
        np.asarray((jqt.q.astype(jx.dtype) * jqt.scale.astype(jx.dtype)).astype(jnp.float32)),
        TL.dequantize_as(tqt, tx.dtype).to(torch.float32).numpy())
    close(got, want, *((ATOL, RTOL) if dtype == "float32" else (0.05, 0.02)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [1024, 8])
def test_attention_dense_and_chunked_match_reference(monkeypatch, window, causal, chunk):
    """``ATTN_CHUNK`` patched small on both modules sends 20 positions
    through the chunked online-softmax path (3 chunks, the last padded)."""
    monkeypatch.setattr(JL, "ATTN_CHUNK", chunk)
    monkeypatch.setattr(TL, "ATTN_CHUNK", chunk)
    jcfg, tcfg = cfgs(causal=causal)
    jp, tp = params(TL.attn_specs, jcfg, tcfg)
    x = rand((2, 20, 32), 2)
    want, _ = JL.attn_fwd(jp, jnp.asarray(x), jcfg, window=window)
    got, _ = TL.attn_fwd(tp, torch.from_numpy(x), tcfg, window=window)
    close(got, want)
    if chunk == 8:  # the chunked path agrees with the port's dense path
        monkeypatch.setattr(TL, "ATTN_CHUNK", 1024)
        dense, _ = TL.attn_fwd(tp, torch.from_numpy(x), tcfg, window=window)
        close(got, dense)


@pytest.mark.parametrize("window,ring", [(None, False), (6, True)])
def test_attention_prefill_cache_and_decode_match_reference(window, ring):
    """Linear and ring caches: the prefill layout ``roll(k[:, -L:], s % L)``
    and three decode steps, caches and outputs."""
    jcfg, tcfg = cfgs()
    jp, tp = params(TL.attn_specs, jcfg, tcfg)
    x = rand((2, 11, 32), 3)
    steps = rand((3, 2, 1, 32), 4)
    max_seq = 16
    spec = TL.attn_cache_shape(tcfg, 2, max_seq, window)
    assert spec.ring == ring and spec == TL.AttnCacheSpec(
        **vars(JL.attn_cache_shape(jcfg, 2, max_seq, window)))
    jspec = JL.attn_cache_shape(jcfg, 2, max_seq, window)
    jy, jc = JL.attn_fwd(jp, jnp.asarray(x), jcfg, window=window, emit_cache=jspec)
    ty, tc = TL.attn_fwd(tp, torch.from_numpy(x), tcfg, window=window, emit_cache=spec)
    close(ty, jy)
    for n in ("k", "v"):
        assert tuple(tc[n].shape) == tuple(jc[n].shape)
        close(tc[n], jc[n])
    for i, xs in enumerate(steps):
        pos = 11 + i
        jy, jc = JL.attn_decode(jp, jnp.asarray(xs), jc, jnp.asarray(pos, jnp.int32), jcfg,
                                window=window, spec=jspec)
        ty, tc = TL.attn_decode(tp, torch.from_numpy(xs), tc, pos, tcfg, window=window,
                                spec=spec)
        close(ty, jy)
        for n in ("k", "v"):
            close(tc[n], jc[n])


def test_linear_cache_write_past_its_end_clamps_like_dynamic_update_slice():
    """A linear cache written at ``pos >= L`` lands in slot ``L - 1``, as
    ``jax.lax.dynamic_update_slice`` clamps its start."""
    jcfg, tcfg = cfgs()
    jp, tp = params(TL.attn_specs, jcfg, tcfg)
    L = 8
    spec = TL.AttnCacheSpec(length=L, ring=False)
    jspec = JL.AttnCacheSpec(length=L, ring=False)
    x = rand((2, 5, 32), 5)
    xs = rand((2, 1, 32), 6)
    _, jc = JL.attn_fwd(jp, jnp.asarray(x), jcfg, emit_cache=jspec)
    _, tc = TL.attn_fwd(tp, torch.from_numpy(x), tcfg, emit_cache=spec)
    for pos in (L, L + 3):
        assert TL.cache_slot(pos, spec) == L - 1
        jy, jc2 = JL.attn_decode(jp, jnp.asarray(xs), jc, jnp.asarray(pos, jnp.int32), jcfg,
                                 spec=jspec)
        ty, tc2 = TL.attn_decode(tp, torch.from_numpy(xs), tc, pos, tcfg, spec=spec)
        close(ty, jy)
        for n in ("k", "v"):
            close(tc2[n], jc2[n])
            # only slot L - 1 changed, and the cache passed in is untouched
            assert torch.equal(tc2[n][:, : L - 1], tc[n][:, : L - 1])
            assert not torch.equal(tc2[n][:, L - 1], tc[n][:, L - 1])
    assert TL.cache_slot(13, TL.AttnCacheSpec(length=L, ring=True)) == 13 % L


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(kind):
    """geglu and gelu use ``jax.nn.gelu``'s tanh approximation: an exact-erf
    GELU misses this tolerance."""
    jcfg, tcfg = cfgs(mlp_kind=kind)
    jp, tp = params(TL.mlp_specs, jcfg, tcfg)
    x = rand((2, 6, 32), 7) * 3
    want = JL.mlp_fwd(jp, jnp.asarray(x), jcfg)
    got = TL.mlp_fwd(tp, torch.from_numpy(x), tcfg)
    close(got, want)
    if kind != "swiglu":
        exact = torch.nn.functional.gelu(torch.from_numpy(x)) - TL.gelu(torch.from_numpy(x))
        assert float(exact.abs().max()) > ATOL


# ---------------------------------------------------------------------------
# quantisation, pruning, policy_einsum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,keep", [
    ((16, 12), (1,)), ((16, 12), (0, 1)), ((3, 16, 12), (0, 2)), ((3, 16, 4, 8), (0, 2, 3)),
    ((3, 16, 4, 8), (0, -1)), ((2, 5, 7), (-1,)),
])
def test_int8_symmetric_keep_bitwise(shape, keep):
    w = rand(shape, 8) * 0.3
    w.flat[0] = 0.0  # a zero and a ties-to-even half in the payload
    want = jq.int8_symmetric_keep(jnp.asarray(w), keep_axes=keep)
    got = tq.int8_symmetric_keep(torch.from_numpy(w), keep_axes=keep)
    assert got.axis == want.axis
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_prune_ffn_keeps_the_reference_channels():
    wi, wo = rand((64, 96), 9), rand((96, 64), 10)
    jwi, jwo, jidx = jpruning.prune_ffn(jnp.asarray(wi), jnp.asarray(wo), keep=40)
    twi, two, tidx = tpruning.prune_ffn(torch.from_numpy(wi), torch.from_numpy(wo), keep=40)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(twi.numpy(), np.asarray(jwi))
    np.testing.assert_array_equal(two.numpy(), np.asarray(jwo))


@pytest.mark.parametrize("prec", list(tq.Precision))
@pytest.mark.parametrize("spec", ["bk,kn->bn", "bsk,kn->bsn"])
def test_policy_einsum_every_mode_matches_reference(prec, spec):
    rng = np.random.default_rng(11)
    shape = (4, 40) if spec == "bk,kn->bn" else (2, 3, 40)
    x = rng.uniform(0.0, 4.0, shape).astype(np.float32)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    want = jpp.policy_einsum(spec, jnp.asarray(x), jnp.asarray(w), jpp.Precision(prec.value))
    got = tpp.policy_einsum(spec, torch.from_numpy(x), torch.from_numpy(w), prec)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    close(got, want, 1e-4, 1e-5)


@pytest.mark.parametrize("prec", [tq.Precision.INT8, tq.Precision.FXP8])
@pytest.mark.parametrize("spec,m", [("mk,kn->mn", 4), ("bk,kn->bn", 9)])
def test_policy_einsum_on_the_w8a8_matmul_bitwise_reference(prec, spec, m):
    """``use_kernel=True``: x per tensor, w per column, then the W8A8 matmul
    (its plain twin here, the reference's Pallas kernel in interpret mode)."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((m, 72)).astype(np.float32)
    w = rng.standard_normal((72, 40)).astype(np.float32)
    want = jpp.policy_einsum(spec, jnp.asarray(x), jnp.asarray(w), jpp.Precision(prec.value),
                             use_kernel=True)
    before = tqmm.quant_matmul.launches
    got = tpp.policy_einsum(spec, torch.from_numpy(x), torch.from_numpy(w), prec,
                            use_kernel=True)
    assert tqmm.quant_matmul.launches == before  # a CPU tensor takes the plain twin
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_cfgs(**kw):
    return cfgs(family="moe", pattern=("moe",), n_experts=4, top_k=2, **kw)


@pytest.mark.parametrize("capacity_factor", [16.0, 0.5, 0.1])
def test_moe_matches_reference_with_and_without_drops(capacity_factor):
    """Low capacity drops (token, k) pairs to slot (E-1, C-1) with a zero
    source: accumulated, a dropped zero never overwrites that slot's writer."""
    jcfg, tcfg = moe_cfgs(capacity_factor=capacity_factor)
    jp, tp = params(TMOE.moe_specs, jcfg, tcfg)
    x = rand((4, 16, 32), 13)
    assert TMOE.capacity(64, tcfg) == JMOE.capacity(64, jcfg)
    want = JMOE.moe_fwd(jp, jnp.asarray(x), jcfg)
    got = TMOE.moe_fwd(tp, torch.from_numpy(x), tcfg)
    close(got, want)


def test_top_k_breaks_ties_toward_the_lower_index_like_lax_top_k():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = TMOE.top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_moe_with_tied_router_matches_reference():
    """A zero router: every expert ties, the gates are the first k."""
    jcfg, tcfg = moe_cfgs(capacity_factor=0.5)
    jp, tp = params(TMOE.moe_specs, jcfg, tcfg)
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    tp = {**tp, "router": torch.zeros_like(tp["router"])}
    x = rand((2, 8, 32), 14)
    close(TMOE.moe_fwd(tp, torch.from_numpy(x), tcfg), JMOE.moe_fwd(jp, jnp.asarray(x), jcfg))


def test_moe_a2a_raises_and_load_balance_loss_matches_reference():
    """``moe_impl="a2a"`` no longer raises (ported with the training
    slice): with no sharding rules active it falls back to the dense MoE,
    as the reference's does, and matches the reference's ``moe_block``."""
    jcfg, tcfg = moe_cfgs(moe_impl="a2a")
    jp, tp = params(TMOE.moe_specs, jcfg, tcfg)
    x = rand((4, 16, 32), 14)
    got = TMOE.moe_block(tp, torch.from_numpy(x), tcfg)
    assert torch.equal(got, TMOE.moe_fwd(tp, torch.from_numpy(x), tcfg))
    close(got, JMOE.moe_block(jp, jnp.asarray(x), jcfg))
    rng = np.random.default_rng(15)
    logits = rng.standard_normal((64, 4)).astype(np.float32)
    idx = rng.integers(0, 4, (64, 2))
    want = JMOE.load_balance_loss(jnp.asarray(logits), jnp.asarray(idx), 4)
    got = TMOE.load_balance_loss(torch.from_numpy(logits), torch.from_numpy(idx), 4)
    close(got, want, 1e-6, 1e-6)
