"""The port's emulation quantisers, precision policy and layer sensitivity
against the JAX reference, on the same seeded numpy inputs.

Tolerances, and why:

* PACT (``pact``, ``pact_quantize``), BF16 and FXP8 are elementwise or take
  an exact ``amax``: bitwise.
* PwQ's scale is ``mean(|w|)``.  The port sums in float64 and rounds once,
  XLA sums a multi-dimensional tensor in an order of its own, so the two
  scales can differ by an ulp.  On weights whose sums are exact in float32
  (a dyadic grid, and weights whose mean is a power of two) PwQ is bitwise.
  On Gaussian weights the quantised values differ by at most one level
  (``span * k / (2^n - 1)``), at fewer than 2 % of the elements, and the
  scale by at most 2 ulps.
* ``clip`` at ties splits the gradient as ``jnp.clip`` does: bitwise.
* Gradients and sums over more than one value (``pact_ste``'s dα, norms,
  sensitivity scores): ``rtol`` 1e-5 (float32 sums in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import precision_policy as jpp  # noqa: E402
from repro.core import quantization as jq  # noqa: E402
from repro.core import sensitivity as js  # noqa: E402
from repro.models import cnn1d as jcnn  # noqa: E402
from repro.training import loop as jloop  # noqa: E402
from repro_torch.core import precision_policy as tpp  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.core import sensitivity as ts  # noqa: E402
from repro_torch.models import cnn1d as tcnn  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402

torch.set_num_threads(1)

MODES = [p.value for p in tq.Precision]
GRAD_RTOL = 1e-5


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def assert_bitwise(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def grid_weights(shape, seed) -> np.ndarray:
    """Multiples of 2**-7 in [-1, 1]: every float32 sum of their absolute
    values is exact, whatever the order."""
    q = np.random.default_rng(seed).integers(-128, 129, size=shape)
    q[(0,) * len(shape)] = 128  # a fixed extreme, so the range is never empty
    return (q / 128.0).astype(np.float32)


def gauss(shape, seed, scale=0.1) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


SHAPES = [(3, 1, 4), (3, 4, 8), (3, 8, 16), (64, 8), (8, 2), (3, 64, 128)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_bits", [8, 16])
def test_pwq_bitwise_on_exact_sums(shape, n_bits):
    w = grid_weights(shape, seed=sum(shape) + n_bits)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    assert_bitwise(tq.pwq_scale(tw, n_bits), jq.pwq_scale(jw, n_bits))
    for got, want in zip(tq.default_clip_bounds(tw, n_bits), jq.default_clip_bounds(jw, n_bits)):
        assert_bitwise(got, want)
    assert_bitwise(tq.pwq_quantize(tw, n_bits), jq.pwq_quantize(jw, n_bits))
    np.testing.assert_allclose(float(tq.pwq_error(tw, n_bits)), float(jq.pwq_error(jw, n_bits)),
                               rtol=GRAD_RTOL)


@pytest.mark.parametrize("e", [-6, -3, 0, 2])
def test_pwq_at_power_of_two_boundaries(e):
    """mean(|w|) a power of two, the extremes on the clip bounds, values on
    the level midpoints of the learned-bounds path, and bounds inside the
    range (clipping on both sides)."""
    mag = np.float32(2.0**e)
    w = np.tile(np.array([mag, -mag, mag / 2, -mag * 1.5, 0.0, mag], np.float32), 8)
    assert float(np.mean(np.abs(w))) == pytest.approx(float(mag) * 5 / 6)
    w[:4] = [mag, -mag, mag, -mag]  # mean(|w|) exactly mag * (5/6)
    equal = np.full(48, mag, np.float32) * np.where(np.arange(48) % 2, 1, -1).astype(np.float32)
    for arr in (w, equal, equal.reshape(3, 4, 4)):
        jw, tw = jnp.asarray(arr), torch.from_numpy(arr)
        assert_bitwise(tq.pwq_scale(tw, 8), jq.pwq_scale(jw, 8))
        assert_bitwise(tq.pwq_quantize(tw, 8), jq.pwq_quantize(jw, 8))
        for lo, hi in ((-0.5, 0.5), (-1.0, 0.25), (0.0, 1.0)):
            got = tq.pwq_quantize(tw, 8, torch.tensor(lo), torch.tensor(hi))
            assert_bitwise(got, jq.pwq_quantize(jw, 8, jnp.float32(lo), jnp.float32(hi)))
    # all-zero weights: the scale falls back to 1 on both sides
    z = np.zeros((3, 2, 2), np.float32)
    assert_bitwise(tq.pwq_quantize(torch.from_numpy(z), 8), jq.pwq_quantize(jnp.asarray(z), 8))


@pytest.mark.parametrize("lo,hi", [(0.5, 1.0), (-0.25, 0.25), (0.7, 0.7)])
def test_clip_splits_tie_gradients_like_jnp_clip(lo, hi):
    """PwQ's clip at a tie: ``jnp.clip`` gives half the gradient to the
    value and half to the bound, as ``torch.minimum``/``torch.maximum`` do;
    ``torch.clamp`` would give all of it to the value.  (Inside PwQ the clip
    feeds ``round``, whose gradient is zero, so the weight gradients do not
    see it; the rule is pinned here for any caller whose clip is not
    rounded.)"""
    x = np.array([lo, 0.5 * (lo + hi), hi, lo - 1.0, hi + 1.0], np.float32)
    g = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)

    def j_fn(x, lo, hi):
        return jnp.sum(jnp.clip(x, lo, hi) * g)

    want = jax.grad(j_fn, argnums=(0, 1, 2))(jnp.asarray(x), jnp.float32(lo), jnp.float32(hi))
    tx = torch.from_numpy(x).requires_grad_(True)
    tlo = torch.tensor(lo, requires_grad=True)
    thi = torch.tensor(hi, requires_grad=True)
    (tq._clip(tx, tlo, thi) * torch.from_numpy(g)).sum().backward()
    for got, w in zip((tx.grad, tlo.grad, thi.grad), want):
        assert_bitwise(got, w)
    assert float(tx.grad[0]) == 0.5 * g[0] or lo == hi


@pytest.mark.parametrize("shape", [(3, 4, 8), (3, 64, 128), (3, 128, 256), (8704, 64)])
@pytest.mark.parametrize("seed", [0, 1])
def test_pwq_within_one_level_on_gaussian_weights(shape, seed):
    w = gauss(shape, seed)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    k_t, k_j = float(tq.pwq_scale(tw, 8)), float(jq.pwq_scale(jw, 8))
    assert abs(k_t - k_j) <= 2 * np.spacing(np.float32(k_j))
    got, want = tq.pwq_quantize(tw, 8).numpy(), np.asarray(jq.pwq_quantize(jw, 8))
    lo, hi = (float(v) for v in jq.default_clip_bounds(jw, 8))
    level = (hi - lo) * k_j / 255.0
    diff = np.abs(got - want)
    assert diff.max() <= level * (1 + 1e-4)
    assert np.mean(diff > 1e-3 * level) < 0.02


@pytest.mark.parametrize("alpha", [6.0, 2.5, 0.37, 1e-13])
@pytest.mark.parametrize("n_bits", [4, 8])
def test_pact_bitwise(alpha, n_bits):
    x = gauss((4, 9, 37), seed=3, scale=3.0)
    x[0, 0, :4] = [0.0, alpha, -alpha, 2 * alpha]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    ja, ta = jnp.float32(alpha), torch.tensor(alpha, dtype=torch.float32)
    assert_bitwise(tq.pact(tx, ta), jq.pact(jx, ja))
    assert_bitwise(tq.pact_quantize(tx, ta, n_bits), jq.pact_quantize(jx, ja, n_bits))
    assert_bitwise(tq.pact_ste(tx, ta, n_bits), jq.pact_ste(jx, ja, n_bits))


@pytest.mark.parametrize("alpha", [6.0, 0.75])
def test_pact_ste_gradients_match_jax_grad(alpha):
    """dx straight through on [0, α] (both ends included), dα the sum of the
    cotangent where x >= α, with x exactly at 0 and at α."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((6, 40)) * alpha).astype(np.float32)
    x[0, :6] = [0.0, alpha, -0.0, np.nextafter(np.float32(alpha), np.float32(0)), -1e-30, alpha]
    g = rng.standard_normal(x.shape).astype(np.float32)

    def j_loss(x, a):
        return jnp.sum(jq.pact_ste(x, a, 8) * g)

    jdx, jda = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x), jnp.float32(alpha))
    tx = torch.from_numpy(x).requires_grad_(True)
    ta = torch.tensor(alpha, dtype=torch.float32, requires_grad=True)
    (tq.pact_ste(tx, ta, 8) * torch.from_numpy(g)).sum().backward()
    assert_bitwise(tx.grad, jdx)
    np.testing.assert_allclose(float(ta.grad), float(jda), rtol=GRAD_RTOL)
    assert ta.grad.shape == () and float(tx.grad[0, 1]) == g[0, 1]  # x == α: straight through


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("axis", [None, 2])
def test_quantize_tensor_modes(mode, axis):
    w = grid_weights((3, 4, 8), seed=5) if mode == "int8" else gauss((3, 4, 8), seed=5)
    got = tq.quantize_tensor(torch.from_numpy(w), tq.Precision(mode), axis=axis)
    assert got.dtype == torch.float32
    assert_bitwise(got, jq.quantize_tensor(jnp.asarray(w), jq.Precision(mode), axis=axis))
    np.testing.assert_allclose(
        tq.quantization_mse(torch.from_numpy(w), tq.Precision(mode)),
        jq.quantization_mse(jnp.asarray(w), jq.Precision(mode)), rtol=GRAD_RTOL, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_activation_quantize_modes_and_gradients(mode):
    x = gauss((2, 8, 16), seed=9, scale=4.0)
    x[0, 0, :3] = [0.0, 2.0, -1.0]
    g = gauss(x.shape, seed=10, scale=1.0)

    def j_loss(x, a):
        return jnp.sum(jq.activation_quantize(x, jq.Precision(mode), a) * g)

    jx, ja = jnp.asarray(x), jnp.float32(2.0)
    assert_bitwise(tq.activation_quantize(torch.from_numpy(x), tq.Precision(mode), 2.0),
                   jq.activation_quantize(jx, jq.Precision(mode), ja))
    jdx, jda = jax.grad(j_loss, argnums=(0, 1))(jx, ja)
    tx = torch.from_numpy(x).requires_grad_(True)
    ta = torch.tensor(2.0, requires_grad=True)
    (tq.activation_quantize(tx, tq.Precision(mode), ta) * torch.from_numpy(g)).sum().backward()
    assert_bitwise(tx.grad, jdx)  # BF16: the cotangent rounded through bf16 on both sides
    np.testing.assert_allclose(0.0 if ta.grad is None else float(ta.grad), float(jda),
                               rtol=GRAD_RTOL, atol=1e-6)


def _grid_params(cfg, seed):
    params = jcnn.init_params(jax.random.PRNGKey(seed), cfg)
    return {layer: {k: np.asarray(grid_weights(v.shape, seed + i) if v.ndim >= 2 else v)
                    for k, v in leaves.items()} for i, (layer, leaves) in enumerate(params.items())}


@pytest.mark.parametrize("spec", ["conv0/w=bf16,dense1/w=fp32", "conv*=fxp8,dense0/w=bf16",
                                  "dense*=int8"])
def test_fake_quant_params(spec):
    cfg = jcnn.CNNConfig(input_len=64, channels=(4, 8), hidden=8)
    tree = _grid_params(cfg, seed=1)
    jpol = jpp.PrecisionPolicy.parse(spec, default="int8")
    tpol = tpp.PrecisionPolicy.parse(spec, default="int8")
    want = jpp.fake_quant_params(jax.tree.map(jnp.asarray, tree), jpol)
    got = tpp.fake_quant_params(tcnn.params_from_numpy(tree), tpol)
    for layer, leaves in want.items():
        for k, v in leaves.items():
            assert_bitwise(got[layer][k], v)


def _ce_setup(seed, policy=None):
    cfg = jcnn.CNNConfig(input_len=64, channels=(4, 8), hidden=8)
    jparams = jcnn.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    y = rng.integers(0, 2, 16).astype(np.int32)
    tparams = tcnn.params_from_numpy(jax.tree.map(np.asarray, jparams))
    tcfg = tcnn.CNNConfig(input_len=64, channels=(4, 8), hidden=8)

    def j_loss(p):
        return jloop.cross_entropy(jcnn.forward(p, jnp.asarray(x), cfg, policy=policy), jnp.asarray(y))

    def t_loss(p):
        tpol = None if policy is None else tpp.PrecisionPolicy.from_dict(policy.to_dict())
        return tloop.cross_entropy(tcnn.forward(p, torch.from_numpy(x), tcfg, policy=tpol),
                                   torch.from_numpy(y))

    return jparams, tparams, j_loss, t_loss


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sensitivity_scores_and_assigned_rules(seed):
    """The detector's scoring recipe (weights only, classifier pinned FP32):
    gradients from ``torch.autograd.grad``, scores within rtol, rules equal."""
    jparams, tparams, j_loss, t_loss = _ce_setup(seed)
    jg = jax.grad(j_loss)(jparams)
    _, tg = ts.value_and_grad(t_loss, tparams)
    want = js.sensitivity_scores({f"{k}/w": v["w"] for k, v in jparams.items()},
                                 {f"{k}/w": v["w"] for k, v in jg.items()})
    got = ts.sensitivity_scores({f"{k}/w": v["w"] for k, v in tparams.items()},
                                {f"{k}/w": v["w"] for k, v in tg.items()})
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-12)
    pinned = {"dense1/w": jq.Precision.FP32}
    for frac in (0.25, 0.5, 0.0):
        jr = js.assign_precisions(want, high_fraction=frac, pinned=pinned)
        tr = ts.assign_precisions(got, high_fraction=frac, pinned={"dense1/w": tq.Precision.FP32})
        assert {k: v.value for k, v in tr.items()} == {k: v.value for k, v in jr.items()}
    # score_with_loss walks every leaf (biases and alphas unscored)
    jall = js.score_with_loss(j_loss, jparams)
    tall = ts.score_with_loss(t_loss, tparams)
    assert tall.keys() == jall.keys()
    for name in jall:
        np.testing.assert_allclose(tall[name], jall[name], rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("kw", [
    {}, {"high_fraction": 0.5}, {"high_fraction": 0.0, "pinned": {"b": "fp32"}},
    {"high_fraction": 1.0, "low_precision": "fxp8", "high_precision": "fp32"},
])
def test_assign_precisions_and_from_sensitivity(kw):
    scores = {"a": 3.0, "b": 0.1, "c": 2.0, "d": 0.5, "e": 0.0}

    def mode_kw(mod):
        out = dict(kw)
        for key in ("low_precision", "high_precision"):
            if key in out:
                out[key] = mod.Precision(out[key])
        if "pinned" in out:
            out["pinned"] = {k: mod.Precision(v) for k, v in out["pinned"].items()}
        return out

    want = js.assign_precisions(scores, **mode_kw(jq))
    got = ts.assign_precisions(scores, **mode_kw(tq))
    assert {k: v.value for k, v in got.items()} == {k: v.value for k, v in want.items()}
    pol = tpp.PrecisionPolicy.from_sensitivity(scores, **mode_kw(tq))
    assert pol.to_json() == jpp.PrecisionPolicy.from_sensitivity(scores, **mode_kw(jq)).to_json()
    assert ts.assign_precisions({}, pinned={"x": tq.Precision.FP32}) == {"x": tq.Precision.FP32}


def test_layer_sensitivity_clamps_at_zero():
    w = torch.from_numpy(grid_weights((8, 8), seed=4))
    assert float(ts.layer_sensitivity(w, torch.zeros_like(w))) == 0.0
    jw = jnp.asarray(w.numpy())
    g = gauss((8, 8), seed=5)
    np.testing.assert_allclose(float(ts.layer_sensitivity(w, torch.from_numpy(g))),
                               float(js.layer_sensitivity(jw, jnp.asarray(g))), rtol=1e-4)
