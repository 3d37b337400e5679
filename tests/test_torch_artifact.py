"""Port quantisers, pruning, precision policy and artifacts against JAX.

The quantisers must be bitwise equal to the reference's, including the
FXP8 exponent at amax = 127 * 2^e +- 1 ulp, where the reference's
``ceil(log2(.))`` and ``exp2`` are not exact; artifacts baked by the port
from the reference's own fp32 params must equal the reference's array for
array (and byte for byte once saved); the golden artifacts must load and
save back unchanged.
"""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import pruning as jprune  # noqa: E402
from repro.core import quantization as jq  # noqa: E402
from repro.core.precision_policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.data.features import FEATURE_DIMS  # noqa: E402
from repro.models import cnn1d as jcnn  # noqa: E402
from repro.serving import quantized_params as jqp  # noqa: E402
from repro_torch.core import f32_math, pruning as tprune, quantization as tq  # noqa: E402
from repro_torch.core.precision_policy import Precision, PrecisionPolicy  # noqa: E402
from repro_torch.models import cnn1d as tcnn  # noqa: E402
from repro_torch.serving import quantized_params as tqp  # noqa: E402
from repro_torch.serving.accelerator import accelerator_forward  # noqa: E402

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parents[1] / "artifacts" / "golden"
SMALL = dict(input_len=FEATURE_DIMS["zcr"], channels=(4, 8), hidden=8)
MIXED = {"conv0/w": "bf16", "dense1/w": "fp32"}


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _jax_params(seed=42, cfg=None):
    cfg = cfg or jcnn.CNNConfig(**SMALL)
    params = jcnn.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# quantisers and the float32 math under them
# ---------------------------------------------------------------------------


def test_exp_log_bits_match_reference():
    rng = np.random.default_rng(0)
    # outputs stay normal: the reference flushes subnormal results to zero
    x = np.concatenate([rng.uniform(-87, 88, 20000), rng.uniform(-1, 1, 20000)]).astype(np.float32)
    assert _bits_equal(jax.jit(jnp.exp)(x), f32_math.exp_f32(torch.from_numpy(x)).numpy())
    y = (10.0 ** rng.uniform(-30, 30, 40000)).astype(np.float32)
    assert _bits_equal(jax.jit(jnp.log)(y), f32_math.log_f32(torch.from_numpy(y)).numpy())
    assert _bits_equal(jax.jit(jnp.log2)(y), f32_math.log2_f32(torch.from_numpy(y)).numpy())
    k = np.arange(-100, 101).astype(np.float32)
    assert _bits_equal(jax.jit(jnp.exp2)(k), f32_math.exp2_f32(torch.from_numpy(k)).numpy())


@pytest.mark.parametrize("fn", ["exp", "exp2"])
def test_exp_flushes_subnormal_results_like_reference(fn):
    """XLA on the CPU flushes subnormal results to zero: ``jnp.exp`` below
    about -87.3 and ``jnp.exp2`` below -126 give 0.0, never a subnormal."""
    jf, tf = {"exp": (jnp.exp, f32_math.exp_f32), "exp2": (jnp.exp2, f32_math.exp2_f32)}[fn]
    x = np.linspace(-104, -80, 240001, dtype=np.float32)
    if fn == "exp2":
        x = np.concatenate([x, np.linspace(-150, -120, 60001, dtype=np.float32)])
    want = np.asarray(jax.jit(jf)(x))
    got = tf(torch.from_numpy(x)).numpy()
    assert _bits_equal(want, got)
    assert (got == 0).any() and not ((got != 0) & (np.abs(got) < np.finfo(np.float32).tiny)).any()


@pytest.mark.parametrize("quant", ["int8_symmetric", "fxp8_quantize"])
def test_jitted_quantizers_have_the_jitted_forward_bits(quant):
    """Inside ``jax.jit`` (the reference's forward, where the activations
    are quantised) XLA turns ``amax / 127`` into ``amax * float32(1/127)``;
    eagerly (the bake) it divides.  ``jitted=True`` matches the first, the
    default the second, on rows where the two differ."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((4000, 64)) * 10.0 ** rng.uniform(-4, 4, (4000, 1))).astype(np.float32)
    jf, tf = getattr(jq, quant), getattr(tq, quant)
    jit_q = jax.jit(lambda v: jf(v, axis=0))(jnp.asarray(w))
    eager_q = jf(jnp.asarray(w), axis=0)
    got = tf(torch.from_numpy(w), axis=0, jitted=True)
    assert _bits_equal(jit_q.scale, got.scale.numpy()) and _bits_equal(jit_q.q, got.q.numpy())
    plain = tf(torch.from_numpy(w), axis=0)
    assert _bits_equal(eager_q.scale, plain.scale.numpy())
    if quant == "int8_symmetric":  # the case the flag exists for
        assert not _bits_equal(jit_q.scale, eager_q.scale)


def test_fma_is_correctly_rounded():
    rng = np.random.default_rng(1)
    a, b, c = (rng.standard_normal(50000).astype(np.float32) * 10.0 ** rng.uniform(-5, 5, 50000).astype(np.float32)
               for _ in range(3))
    got = f32_math.fma_f32(*map(torch.from_numpy, (a, b, c))).numpy()
    # exact rational reference for a subset, via Python fractions of floats
    from fractions import Fraction

    for i in range(0, 50000, 97):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        want = np.float32(float(exact))  # one rounding of the double nearest
        lo, hi = np.nextafter(want, -np.inf), np.nextafter(want, np.inf)
        best = min((want, lo, hi), key=lambda v: abs(Fraction(float(v)) - exact))
        assert got[i] == best


@pytest.mark.parametrize("quant", ["int8_symmetric", "fxp8_quantize"])
def test_quantizers_bitwise_at_power_of_two_boundaries(quant):
    jf, tf = getattr(jq, quant), getattr(tq, quant)
    es = np.arange(-40, 30)
    amax = (127.0 * np.ldexp(1.0, es)).astype(np.float32)
    cands = np.concatenate([
        np.nextafter(amax, -np.inf, dtype=np.float32), amax,
        np.nextafter(amax, np.inf, dtype=np.float32),
    ])
    w = np.stack([cands, -cands / 3, cands / 7], axis=1).astype(np.float32)
    for axis in (0, None):
        j = jf(jnp.asarray(w), axis=axis)
        t = tf(torch.from_numpy(w), axis=axis)
        assert _bits_equal(j.q, t.q.numpy()) and _bits_equal(j.scale, t.scale.numpy())
    for row in w[:: 7]:  # per-tensor scalars hit the scalar code path
        j, t = jf(jnp.asarray(row)), tf(torch.from_numpy(row))
        assert _bits_equal(j.q, t.q.numpy()) and _bits_equal(j.scale, t.scale.numpy())


@pytest.mark.parametrize("shape,axis", [((3, 5, 7), None), ((3, 5, 7), 2), ((33, 9), 1), ((8, 300, 4), 0)])
def test_quantizers_bitwise_random(shape, axis):
    rng = np.random.default_rng(len(shape) * 10 + (axis or 0))
    w = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, size=shape)).astype(np.float32)
    for name in ("int8_symmetric", "fxp8_quantize"):
        j = getattr(jq, name)(jnp.asarray(w), axis=axis)
        t = getattr(tq, name)(torch.from_numpy(w), axis=axis)
        assert t.axis == j.axis
        assert _bits_equal(j.q, t.q.numpy()) and _bits_equal(j.scale, t.scale.numpy())
        assert _bits_equal(j.dequantize(), t.dequantize().numpy())


def test_precision_enum_matches():
    for p in jq.Precision:
        t = tq.Precision(p.value)
        assert (t.bits, t.is_integer) == (p.bits, p.is_integer)


# ---------------------------------------------------------------------------
# pruning and the precision policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,keep,trim", [((3, 4, 8), 3, 1), ((3, 16, 32), 8, 0), ((3, 128, 256), 64, 1)])
def test_plan_prune_same_spec(shape, keep, trim):
    w = np.random.default_rng(shape[-1]).standard_normal(shape).astype(np.float32)
    js = jprune.plan_prune(jnp.asarray(w), 32, keep=keep, trim_frames=trim)
    ts = tprune.plan_prune(torch.from_numpy(w), 32, keep=keep, trim_frames=trim)
    assert ts.to_dict() == js.to_dict() and ts.cache_key == js.cache_key
    assert ts.reduction == js.reduction
    assert tprune.PruneSpec.from_dict(js.to_dict()).cache_key == js.cache_key
    b = np.arange(shape[-1], dtype=np.float32)
    jw, jb = jprune.apply_prune_conv(jnp.asarray(w), jnp.asarray(b), js)
    tw, tb = tprune.apply_prune_conv(torch.from_numpy(w), torch.from_numpy(b), ts)
    assert _bits_equal(jw, tw.numpy()) and _bits_equal(jb, tb.numpy())
    d = np.random.default_rng(1).standard_normal((32 * shape[-1], 5)).astype(np.float32)
    assert _bits_equal(
        jprune.apply_prune_dense(jnp.asarray(d), js, 32, shape[-1]),
        tprune.apply_prune_dense(torch.from_numpy(d), ts, 32, shape[-1]).numpy(),
    )


@pytest.mark.parametrize("spec", [
    "conv0/w=bf16,dense1/w=fp32",
    "conv*/w=int8, dense?/w=fxp8 ,conv1/w=fp32",
    '{"default": "int8", "rules": {"dense*": "bf16", "dense1/w": "fp32"}}',
])
def test_precision_policy_parse_and_json_equal(spec, tmp_path):
    paths = ["conv0/w", "conv1/w", "conv2/w", "dense0/w", "dense1/w", "other"]
    for default in (None, "int8"):
        j = JPolicy.parse(spec, default=default)
        t = PrecisionPolicy.parse(spec, default=default)
        assert t.to_json() == j.to_json()
        assert [t.precision_for(p).value for p in paths] == [j.precision_for(p).value for p in paths]
        f = tmp_path / "policy.json"
        f.write_text(j.to_json())
        assert PrecisionPolicy.parse(str(f)).to_json() == j.to_json()
    with pytest.raises(ValueError, match="pattern=mode"):
        PrecisionPolicy.parse("conv0/w")


def test_precision_policy_resolution_ignores_insertion_order():
    rules = {"conv*": Precision.INT8, "conv0/w": Precision.BF16, "conv?/w": Precision.FXP8}
    a = PrecisionPolicy(rules=dict(rules))
    b = PrecisionPolicy(rules=dict(reversed(list(rules.items()))))
    for p in ("conv0/w", "conv1/w", "conv12/w", "dense0/w"):
        assert a.precision_for(p) == b.precision_for(p)
    assert PrecisionPolicy.from_json(a.to_json()) == a


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------


def _cells(cfg, params, prune_mod, policy_cls):
    spec = prune_mod.plan_prune(params["conv1"]["w"], cfg.n_frames, keep=3, trim_frames=1)
    mixed = policy_cls(rules={k: jq.Precision(v) for k, v in MIXED.items()},
                       default=jq.Precision.INT8)
    return {"int8": dict(mode="int8"), "fxp8": dict(mode="fxp8"),
            "pruned_mixed": dict(mode="int8", prune=spec, policy=mixed)}


@pytest.mark.parametrize("cell", ["int8", "fxp8", "pruned_mixed"])
def test_port_bake_equals_reference_bake(cell, tmp_path):
    cfg, np_params = _jax_params()
    jparams = jax.tree.map(jnp.asarray, np_params)
    jkw = _cells(cfg, jparams, jprune, JPolicy)[cell]
    tcfg = tcnn.CNNConfig(**SMALL)
    tparams = tcnn.params_from_numpy(np_params)
    tkw = dict(jkw)
    if "prune" in tkw:
        tkw["prune"] = tprune.plan_prune(tparams["conv1"]["w"], tcfg.n_frames, keep=3, trim_frames=1)
        tkw["policy"] = PrecisionPolicy(rules={k: Precision(v) for k, v in MIXED.items()},
                                        default=Precision.INT8)
        assert tkw["prune"].cache_key == jkw["prune"].cache_key
    jart = jqp.quantize_params(jparams, cfg, **jkw)
    tart = tqp.quantize_params(tparams, tcfg, device="cpu", **tkw)
    assert tart.layer_modes == jart.layer_modes and tart.keep_frames == jart.keep_frames
    for jl, tl in zip(jart.convs + jart.denses, tart.convs + tart.denses):
        if isinstance(jl["w"], jq.QTensor):
            assert _bits_equal(jl["w"].q, tl["w"].q.numpy())
            assert _bits_equal(jl["w"].scale, tl["w"].scale.numpy())
            assert jl["w"].axis == tl["w"].axis
        else:
            assert _bits_equal(np.asarray(jl["w"], np.float32), tl["w"].float().numpy())
        assert _bits_equal(jl["b"], tl["b"].numpy())
    jqp.save_artifact(tmp_path / "j.npz", jart)
    tqp.save_artifact(tmp_path / "t.npz", tart)
    assert (tmp_path / "j.npz").read_bytes() == (tmp_path / "t.npz").read_bytes()


@pytest.mark.parametrize("name", ["int8", "pruned_mixed", "int8_ondevice"])
def test_golden_artifact_load_save_roundtrip(name, tmp_path):
    src = GOLDEN / f"detector_{name}.npz"
    art = tqp.load_artifact(src, device="cpu")
    assert art.device.type == "cpu"
    tqp.save_artifact(tmp_path / "t.npz", art)
    with np.load(src) as want, np.load(tmp_path / "t.npz") as got:
        assert sorted(want.files) == sorted(got.files)
        for key in want.files:
            assert _bits_equal(want[key], got[key]), key
    # byte-identical to the reference's own re-save of the same file
    jqp.save_artifact(tmp_path / "j.npz", jqp.load_artifact(src))
    assert (tmp_path / "j.npz").read_bytes() == (tmp_path / "t.npz").read_bytes()
    ref = jqp.load_artifact(src)
    assert art.layer_modes == ref.layer_modes and art.feature_kind == ref.feature_kind
    assert (art.mixed, art.pruned, art.fxp) == (ref.mixed, ref.pruned, ref.fxp)


def test_quantize_calls_flat_across_serving_calls():
    cfg = tcnn.CNNConfig(**SMALL)
    params = tcnn.init_params(cfg, torch.Generator().manual_seed(0))
    cache = tqp.QuantizedParamsCache(params, cfg, device="cpu")
    before = tqp.quantize_calls
    qp = cache.get("int8")
    assert tqp.quantize_calls - before == len(cfg.channels) + 2  # one per weight
    assert cache.get("int8") is qp and cache.get("fxp8") is not qp
    baked = tqp.quantize_calls
    x = np.random.default_rng(0).standard_normal((4, cfg.input_len)).astype(np.float32)
    for _ in range(3):
        accelerator_forward(qp, x, cfg, device="cpu")
    assert tqp.quantize_calls == baked


def test_init_params_shapes_match_reference():
    cfg = tcnn.CNNConfig(**SMALL)
    jp = jcnn.init_params(jax.random.PRNGKey(0), jcnn.CNNConfig(**SMALL))
    tp = tcnn.init_params(cfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == {
        k: {kk: tuple(v.shape) for kk, v in d.items()} for k, d in tp.items()
    }
    assert tcnn.CANONICAL.flatten_size == 35_072 == jcnn.CANONICAL.flatten_size


def test_bake_validates():
    cfg = tcnn.CNNConfig(**SMALL)
    params = tcnn.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="mode"):
        tqp.quantize_params(params, cfg, mode="int4", device="cpu")
    with pytest.raises(ValueError, match="feature kind"):
        tqp.quantize_params(params, cfg, feature_kind="mfcc20", device="cpu")
    bad = tprune.PruneSpec(np.arange(3), np.array([0, 2]), cfg.flatten_size, 6)
    with pytest.raises(ValueError, match="contiguous prefix"):
        tqp.quantize_params(params, cfg, prune=bad, device="cpu")
