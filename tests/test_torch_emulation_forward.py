"""The port's emulation forward against the JAX reference: logits and
``jax.grad`` of the cross-entropy under every policy, the pruned forward,
and ``predict``.

The same seeded numpy inputs and the reference's params (``params_from_numpy``
of a ``jax.random`` init, PACT clips calibrated so that the 8-bit modes
clip and tie) go through both packages at small widths (``channels=(4,
8)``, ``hidden=8``).  Tolerances, and why:

* logits: ``LOGIT_ATOL`` 1e-5 under every policy (float32 convs and
  matmuls sum in another order; the quantisers' rounding sees the same
  values, measured below 2.4e-6);
* ``jax.grad`` of the cross-entropy, every param under FP32, BF16, INT8,
  FXP8 and the mixed policy: ``GRAD_RTOL`` 1e-5 of the leaf's largest
  gradient (measured below 9e-7).  Ties matter here: quantised
  activations tie in the max-pool, whose gradient XLA gives to the first
  value (a ``torch.maximum`` pool fails these cases);
* ``predict`` against the reference's jitted ``predict``: the jit divides
  by the level count as a reciprocal multiply, so an 8-bit policy can flip
  one level of one activation: within 0.02 at a few logits, decisions
  equal (against the eager forward: ``LOGIT_ATOL``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.precision_policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import cnn1d as jcnn  # noqa: E402
from repro.training import loop as jloop  # noqa: E402
from repro_torch.core.precision_policy import PrecisionPolicy  # noqa: E402
from repro_torch.core.sensitivity import value_and_grad  # noqa: E402
from repro_torch.models import cnn1d as tcnn  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402

torch.set_num_threads(1)

LOGIT_ATOL = 1e-5
GRAD_RTOL = 1e-5
SMALL = dict(input_len=128, channels=(4, 8), hidden=8)
POLICIES = {"fp32": None, "bf16": "*=bf16", "int8": "*=int8", "fxp8": "*=fxp8",
            "mixed": "conv0/w=bf16,dense1/w=fp32"}


def _setup(seed, rows=16, calibrate=True, **cfg_kw):
    kw = {**SMALL, **cfg_kw}
    jcfg, tcfg = jcnn.CNNConfig(**kw), tcnn.CNNConfig(**kw)
    jp = jcnn.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, kw["input_len"])).astype(np.float32)
    y = rng.integers(0, 2, rows).astype(np.int32)
    if calibrate:  # realistic clips: the 8-bit modes then clip and tie
        jp = jcnn.calibrate_alphas(jp, jnp.asarray(x), jcfg)
    tp = tcnn.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp, x, y


def _policies(name):
    spec = POLICIES[name]
    if spec is None:
        return None, None
    return JPolicy.parse(spec, default="int8"), PrecisionPolicy.parse(spec, default="int8")


def _assert_grads_close(tg, jg):
    for layer, leaves in jg.items():
        for k, want in leaves.items():
            want = np.asarray(want)
            got = tg[layer][k].numpy()
            assert got.shape == want.shape, (layer, k)
            tol = GRAD_RTOL * max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"{layer}/{k}")


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_logits_and_grads_match_reference(policy, seed):
    jcfg, tcfg, jp, tp, x, y = _setup(seed)
    jpol, tpol = _policies(policy)
    want = np.asarray(jcnn.forward(jp, jnp.asarray(x), jcfg, policy=jpol))
    got = tcnn.forward(tp, torch.from_numpy(x), tcfg, policy=tpol).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)

    jg = jax.grad(lambda p: jloop.cross_entropy(
        jcnn.forward(p, jnp.asarray(x), jcfg, policy=jpol), jnp.asarray(y)))(jp)
    _, tg = value_and_grad(lambda p: tloop.cross_entropy(
        tcnn.forward(p, torch.from_numpy(x), tcfg, policy=tpol), torch.from_numpy(y)), tp)
    _assert_grads_close(tg, jg)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_forward_pruned_logits_and_grads_match_reference(policy):
    jcfg, tcfg, jp, tp, x, y = _setup(3)
    jpol, tpol = _policies(policy)
    jpp, jpcfg, jspec = jcnn.prune_model(jp, jcfg, keep=4, trim_frames=1)
    tpp, tpcfg, tspec = tcnn.prune_model(tp, tcfg, keep=4, trim_frames=1)
    assert tspec.to_dict() == jspec.to_dict() and tpcfg.channels == jpcfg.channels
    want = np.asarray(jcnn.forward_pruned(jpp, jnp.asarray(x), jpcfg, jspec, policy=jpol))
    got = tcnn.forward_pruned(tpp, torch.from_numpy(x), tpcfg, tspec, policy=tpol)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=LOGIT_ATOL)
    jg = jax.grad(lambda p: jloop.cross_entropy(
        jcnn.forward_pruned(p, jnp.asarray(x), jpcfg, jspec, policy=jpol), jnp.asarray(y)))(jpp)
    _, tg = value_and_grad(lambda p: tloop.cross_entropy(
        tcnn.forward_pruned(p, torch.from_numpy(x), tpcfg, tspec, policy=tpol),
        torch.from_numpy(y)), tpp)
    _assert_grads_close(tg, jg)


def test_forward_pruned_skips_bf16_activation_rounding_like_reference():
    """The reference's quirk, kept: ``forward`` rounds a BF16 layer's
    activations to bf16, ``forward_pruned`` does not.  With a prune that
    keeps everything the two agree under FP32 and differ under BF16, in
    both packages, by the same amount."""
    jcfg, tcfg, jp, tp, x, _ = _setup(4, calibrate=False)
    jpol, tpol = _policies("bf16")
    n_ch, n_fr = tcfg.channels[-1], tcfg.n_frames
    tpp, tpcfg, tspec = tcnn.prune_model(tp, tcfg, keep=n_ch, trim_frames=0)
    jpp, jpcfg, jspec = jcnn.prune_model(jp, jcfg, keep=n_ch, trim_frames=0)
    assert tspec.flatten_after == n_ch * n_fr
    tx = torch.from_numpy(x)
    full_fp32 = tcnn.forward(tp, tx, tcfg).detach()
    assert torch.equal(tcnn.forward_pruned(tpp, tx, tpcfg, tspec).detach(), full_fp32)
    t_gap = (tcnn.forward_pruned(tpp, tx, tpcfg, tspec, policy=tpol)
             - tcnn.forward(tp, tx, tcfg, policy=tpol)).detach().abs().max()
    j_gap = np.abs(np.asarray(jcnn.forward_pruned(jpp, jnp.asarray(x), jpcfg, jspec, policy=jpol))
                   - np.asarray(jcnn.forward(jp, jnp.asarray(x), jcfg, policy=jpol))).max()
    assert float(t_gap) > 1e-4 and j_gap > 1e-4
    np.testing.assert_allclose(float(t_gap), j_gap, rtol=1e-3)


@pytest.mark.parametrize("keep,trim", [(4, 0), (2, 1), (8, 1)])
def test_pruned_forward_equals_masked_full_forward(keep, trim):
    """Pruning == zeroing the dropped channels (and the trimmed frames'
    dense rows) of the unpruned model."""
    _, tcfg, _, tp, x, _ = _setup(5, calibrate=False)
    pruned, pcfg, spec = tcnn.prune_model(tp, tcfg, keep=keep, trim_frames=trim)
    masked = {k: dict(v) for k, v in tp.items()}
    ch = torch.zeros(tcfg.channels[-1])
    ch[torch.as_tensor(spec.keep_channels)] = 1
    fr = torch.zeros(tcfg.n_frames)
    fr[torch.as_tensor(spec.keep_frames)] = 1
    masked["conv1"]["w"] = tp["conv1"]["w"] * ch
    masked["conv1"]["b"] = tp["conv1"]["b"] * ch
    rows = (fr[:, None] * ch[None, :]).reshape(-1, 1)
    masked["dense0"]["w"] = tp["dense0"]["w"] * rows
    tx = torch.from_numpy(x)
    got = tcnn.forward_pruned(pruned, tx, pcfg, spec).detach()
    want = tcnn.forward(masked, tx, tcfg).detach()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("policy", ["fp32", "int8", "fxp8", "mixed"])
def test_predict_matches_reference(policy):
    """``predict`` against the eager reference forward within
    ``LOGIT_ATOL``, and against the reference's jitted ``predict``: its jit
    divides by the level count as a reciprocal multiply, so an 8-bit
    policy's rounding can flip one level of one activation; there the
    logits agree within ``JIT_FLIP_ATOL`` 0.02 at a few values, and the
    decisions agree."""
    jcfg, tcfg, jp, tp, x, _ = _setup(9, rows=40)
    jpol, tpol = _policies(policy)
    got = tloop.predict(tp, x, tcfg, policy=tpol, batch=16)
    eager = np.asarray(jcnn.forward(jp, jnp.asarray(x), jcfg, policy=jpol))
    assert got.shape == eager.shape == (40, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, eager, rtol=0, atol=LOGIT_ATOL)
    jitted = jloop.predict(jp, x, jcfg, policy=jpol, batch=16)
    off = np.abs(got - jitted) > LOGIT_ATOL
    assert off.mean() <= (0.05 if policy in ("int8", "fxp8") else 0.0)
    np.testing.assert_allclose(got, jitted, rtol=0, atol=0.02)
    assert np.array_equal(got.argmax(1), jitted.argmax(1))
    labels = (np.arange(40) % 2).astype(np.int32)
    assert tloop.evaluate_logits(got, labels).row() == jloop.evaluate_logits(jitted, labels).row()
