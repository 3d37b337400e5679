"""The port's LM training step against the JAX reference, all ten archs.

Weights are drawn once by the port (``init_params(seed, cfg,
device="cpu")``), carried to numpy by ``params_to_numpy`` and handed to
both packages; tokens, frames, patches and labels (about a fifth of them
-1, masked) come from a seeded numpy generator.  Smoke configs, fp32.  The
reference runs jitted, once per arch (``reference``, cached).

Limits.  Some smoke configs are ill-conditioned (gemma3-12b's twelve
layers: a one-ulp nudge of every weight moves its gradients by 1.9e-3 of
their scale), so each metric is held to ``ULPS`` times what such a nudge
moves it by in the reference itself, or to a floor where that is larger
(``limits``), as ``chip_smoke.py`` holds the card to the CPU.  The metrics:
the loss (``loss_fn``'s and the step's mean over microbatches, relative);
every gradient leaf of ``loss_fn`` and the step's moments ``mu`` (0.1 x
the accumulated gradient) and ``nu``, as ``max|port - JAX| / max|JAX|``
over the leaf; the updated params, absolute.  The step runs Adam without
clipping (so a wrong scale of the gradient cannot hide behind the clip)
and with ``eps`` 1e-3 (with 1e-8 the first step is the sign of each
gradient, which flips on values at the noise floor).  The sound port reads
at most 2.53 of the nudge's change (``nu``; ``mu`` 1.70, gradients 1.50,
params 1.46) over the ten archs and ``n_micro`` 1-4, so ``ULPS`` 8 is
three times that; a loss that ignores the mask and a step that sums its
microbatches are both rejected (``test_planted_faults_exceed_the_limits``).
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
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import compression as JC  # noqa: E402
from repro.training import lm as JLM  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core.sensitivity import value_and_grad  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.training import compression as TC  # noqa: E402
from repro_torch.training import lm as TLM  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

torch.set_num_threads(1)

ARCHS = lm_arch_names()
B, S, N_MICRO, LR, EPS = 4, 16, 2, 1e-3, 1e-3
FLOOR = {"loss": 1e-6, "step_loss": 1e-6, "grads": 1e-5, "mu": 1e-5, "nu": 1e-5,
         "params": 1e-6}
ULPS = 8


def to_jax(np_tree, cfg):
    """A numpy params tree (``params_to_numpy``) as the reference's params."""
    specs = JT.build_specs(cfg)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        return jnp.asarray(t, jnp.dtype(s.dtype or cfg.param_dtype))

    return walk(np_tree, specs)


def np_tree(tree):
    """A JAX or torch tree as numpy float32, keys sorted."""
    if isinstance(tree, dict):
        return {k: np_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(torch.float32).numpy()
    return np.asarray(tree, np.float32)


def leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def train_batch(cfg, seed=1, b=B, s=S):
    """Seeded inputs and labels, about a fifth of the labels -1."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "audio_frames":
        batch["frames"] = rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.frontend == "vision_patches":
        batch["patches"] = rng.standard_normal((b, cfg.n_patches, cfg.frontend_dim)).astype(
            np.float32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < 0.2] = -1
    batch["labels"] = labels
    return batch


def smoke(arch, **kw):
    return jget_config(arch).smoke().replace(**kw), tget_config(arch).smoke().replace(**kw)


@functools.lru_cache(maxsize=None)
def setup(arch, **kw):
    jcfg, tcfg = smoke(arch, **kw)
    tp = TT.init_params(0, tcfg, device="cpu")
    return jcfg, tcfg, TT.params_to_numpy(tp)


def port_params(np_params, cfg):
    return TT.params_from_numpy(np_params, cfg)


def nudged(tree, seed=0):
    """Every weight moved by one ulp, up or down at random (a factor 1 +-
    2^-23): how far fp32 rounding alone can move a result."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return (t * (1 + 2.0 ** -23 * np.sign(rng.standard_normal(t.shape)))).astype(np.float32)

    return walk(tree)


@functools.lru_cache(maxsize=None)
def reference(arch, n_micro=N_MICRO, b=B):
    """The reference, jitted: ``loss_fn``'s value and gradients on the
    whole batch, and one ``make_train_step`` (``n_micro``) from Adam's
    zero state (loss, updated params and moments), all numpy; and the same
    on one-ulp-nudged weights (``"nudged"``)."""
    jcfg, _, npp = setup(arch)
    batch = {k: jnp.asarray(v) for k, v in train_batch(jcfg, b=b).items()}
    vg = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, b, jcfg)))
    opt = JO.Adam(lr=LR, eps=EPS, grad_clip_norm=None)
    step = jax.jit(JLM.make_train_step(jcfg, opt, JLM.TrainSettings(n_micro=n_micro)))
    out = {}
    for name, weights in (("base", npp), ("nudged", nudged(npp))):
        jp = to_jax(weights, jcfg)
        loss, grads = vg(jp, batch)
        p2, o2, metrics = step(jp, opt.init(jp), batch)
        out[name] = {"loss": float(loss), "grads": np_tree(grads),
                     "step_loss": float(metrics["loss"]), "params": np_tree(p2),
                     "mu": np_tree(o2.mu), "nu": np_tree(o2.nu)}
    return out["base"], errors(out["nudged"], out["base"])


def port_run(arch, n_micro=N_MICRO, loss_fn=None, b=B):
    _, tcfg, npp = setup(arch)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(tcfg, b=b).items()}
    loss_fn = loss_fn or TT.loss_fn
    loss, grads = value_and_grad(lambda p: loss_fn(p, batch, tcfg), port_params(npp, tcfg))
    opt = TO.Adam(lr=LR, eps=EPS, grad_clip_norm=None)
    params = port_params(npp, tcfg)
    step = TLM.make_train_step(tcfg, opt, TLM.TrainSettings(n_micro=n_micro))
    p2, o2, metrics = step(params, opt.init(params), batch)
    return {"loss": float(loss), "grads": np_tree(grads), "step_loss": float(metrics["loss"]),
            "params": np_tree(p2), "mu": np_tree(o2.mu), "nu": np_tree(o2.nu)}


def rel_err(got: dict, want: dict) -> float:
    """Largest ``max|got - want| / max|want|`` over the leaves."""
    worst = 0.0
    for (path, a), (_, b) in zip(leaves(got), leaves(want)):
        scale = float(np.abs(b).max())
        if scale == 0:
            assert float(np.abs(a).max()) == 0, path
            continue
        worst = max(worst, float(np.abs(a - b).max()) / scale)
    return worst


def abs_err(got: dict, want: dict) -> float:
    return max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(leaves(got), leaves(want)))


def errors(got, want) -> dict:
    return {
        "loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
        "step_loss": abs(got["step_loss"] - want["step_loss"]) / abs(want["step_loss"]),
        "grads": rel_err(got["grads"], want["grads"]),
        "mu": rel_err(got["mu"], want["mu"]),
        "nu": rel_err(got["nu"], want["nu"]),
        "params": abs_err(got["params"], want["params"]),
    }


def limits(nudge: dict) -> dict:
    """Each metric's limit: ``ULPS`` times what a one-ulp nudge of the
    weights moves it by in the reference, or the floor where larger."""
    return {k: max(FLOOR[k], ULPS * v) for k, v in nudge.items()}


def within_limits(err: dict, nudge: dict) -> bool:
    lim = limits(nudge)
    return all(err[k] <= lim[k] for k in err)


# ---------------------------------------------------------------------------
# loss_fn and one train step, every arch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_train_step_match_reference(arch):
    want, nudge = reference(arch)
    got = port_run(arch)
    assert set(k for k, _ in leaves(got["grads"])) == set(k for k, _ in leaves(want["grads"]))
    err = errors(got, want)
    assert within_limits(err, nudge), (err, limits(nudge))


@pytest.mark.parametrize("n_micro", [1, 3, 4])
def test_train_step_matches_reference_at_other_micro_counts(n_micro):
    """n_micro 1-4 (2 above); a batch of 12 rows split into 1, 3 and 4."""
    want, nudge = reference("gemma-2b", n_micro, b=12)
    err = errors(port_run("gemma-2b", n_micro, b=12), want)
    assert within_limits(err, nudge), (err, limits(nudge))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7])
def test_micro_means_have_the_jitted_reference_bits(n):
    """Inside ``jax.jit`` ``g / n`` and ``losses.mean()`` multiply by the
    float32 reciprocal of ``n``; the port's step does the same."""
    x = np.random.default_rng(n).standard_normal(4096).astype(np.float32)
    want = np.asarray(jax.jit(lambda g: g / n)(x))
    inv = torch.tensor(1.0 / n, dtype=torch.float32)
    assert np.array_equal((torch.from_numpy(x) * inv).numpy().view(np.int32), want.view(np.int32))
    losses = x[:n]
    want = np.float32(jax.jit(lambda v: v.mean())(losses))
    acc = torch.from_numpy(losses[:1])[0]
    for v in losses[1:]:
        acc = acc + torch.tensor(v)
    assert np.float32((acc * inv).item()).view(np.int32) == want.view(np.int32)


def test_planted_faults_exceed_the_limits():
    """The limits reject a loss that ignores the mask and a step that sums
    its microbatches instead of averaging them."""
    arch = "gemma-2b"
    want, nudge = reference(arch)

    def unmasked(params, batch, cfg, count=None):
        b = dict(batch)
        b["labels"] = torch.clamp_min(b["labels"], 0)
        return TT.loss_fn(params, b, cfg)

    assert not within_limits(errors(port_run(arch, loss_fn=unmasked), want), nudge)
    orig = torch.Tensor.mul_
    try:
        def summed(self, other):  # the micro mean's multiply by 1/n skipped
            if self.dtype == torch.float32 and getattr(other, "ndim", 1) == 0 \
                    and float(other) == 1 / N_MICRO:
                return self
            return orig(self, other)
        torch.Tensor.mul_ = summed
        got = port_run(arch)
    finally:
        torch.Tensor.mul_ = orig
    err = errors(got, want)
    assert err["mu"] > limits(nudge)["mu"], err


def test_loss_fn_over_text_positions_and_frames():
    """internvl2's loss runs over the text positions after its patches,
    hubert's framewise; an all-masked batch divides by one."""
    for arch in ("internvl2-1b", "hubert-xlarge"):
        _, tcfg, npp = setup(arch)
        batch = {k: torch.from_numpy(v) for k, v in train_batch(tcfg).items()}
        batch["labels"] = torch.full_like(batch["labels"], -1)
        assert float(TT.loss_fn(port_params(npp, tcfg), batch, tcfg)) == 0.0


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "phi3.5-moe", "gemma-2b", "zamba2-7b"])
def test_remat_changes_no_bit(arch):
    """Recomputing each group in the backward (MoE routing and capacity
    drops included: the smoke configs' default capacity factor drops
    tokens) gives the same loss and gradients, bitwise."""
    _, tcfg, npp = setup(arch)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(tcfg).items()}
    out = {}
    for remat in (False, True):
        cfg = tcfg.replace(remat=remat)
        out[remat] = value_and_grad(lambda p: TT.loss_fn(p, batch, cfg), port_params(npp, cfg))
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(tree_leaves(out[False][1]), tree_leaves(out[True][1])):
        assert torch.equal(a, b)


def test_moe_smoke_configs_drop_tokens():
    """The remat test's MoE configs do drop tokens (capacity binds)."""
    from repro_torch.models import moe

    _, tcfg, _ = setup("olmoe-1b-7b")
    t = B * S
    assert moe.capacity(t, tcfg) < t * tcfg.top_k


# ---------------------------------------------------------------------------
# the optimizer's leaf order
# ---------------------------------------------------------------------------


def test_adam_with_clip_matches_reference_on_an_lm_tree():
    """The LM params are built in sorted-key order, the reference's
    ``tree_leaves`` order, so the clip's global norm sums their leaves in
    the reference's order; the update then matches and leaves its inputs
    as they were (the driver's SIGTERM save reads them mid-step)."""
    _, tcfg, npp = setup("gemma-2b")
    params = TT.init_params(0, tcfg, device="cpu")
    assert [k for k, _ in leaves(params)] == [k for k, _ in _insertion_leaves(params)]
    rng = np.random.default_rng(5)
    grads = {p: rng.standard_normal(a.shape).astype(np.float32) for p, a in leaves(npp)}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    tp = {k: torch.from_numpy(a) for k, a in leaves(npp)}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    jp = {k: jnp.asarray(a) for k, a in leaves(npp)}
    assert np.float32(TO.global_norm(tg)) == np.float32(jax.jit(JO.global_norm)(jg))
    topt, jopt = TO.Adam(lr=LR), JO.Adam(lr=LR)
    before = {k: (tp[k].clone(), tg[k].clone()) for k in tp}
    tst0 = topt.init(tp)
    tnew, tst = topt.update(tg, tst0, tp)
    jnew, jst = jax.jit(jopt.update)(jg, jopt.init(jp), jp)
    assert abs_err(np_tree(tnew), np_tree(jnew)) <= FLOOR["params"]
    assert int(tst0.step) == 0 and int(tst.step) == 1
    for k, (p0, g0) in before.items():
        assert torch.equal(tp[k], p0) and torch.equal(tg[k], g0)
        assert not tst0.mu[k].any() and not tst0.nu[k].any()


def _insertion_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _insertion_leaves(v, f"{path}/{k}")
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# compression and the synthetic stream
# ---------------------------------------------------------------------------


def _grads_like(rng):
    return [rng.standard_normal((64, 48)).astype(np.float32) * 3e-3,
            rng.standard_normal(5000).astype(np.float32),
            np.zeros((40, 40), np.float32),
            (rng.standard_normal(2048) * 1e-30).astype(np.float32)]


def _bits(a):
    return np.asarray(a).view(np.int32 if np.asarray(a).dtype == np.float32 else np.int8)


@pytest.mark.parametrize("jitted", [False, True])
def test_int8_compress_has_reference_bits(jitted):
    rng = np.random.default_rng(7)
    jfn = jax.jit(JC.int8_compress) if jitted else JC.int8_compress
    for g in _grads_like(rng):
        jq, js = jfn(jnp.asarray(g))
        tq, ts = TC.int8_compress(torch.from_numpy(g), jitted=jitted)
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert np.float32(ts).view(np.int32) == np.float32(js).view(np.int32)
        assert np.array_equal(_bits(TC.int8_decompress(tq, ts).numpy()),
                              _bits(JC.int8_decompress(jq, js)))
    err = rng.standard_normal((64, 48)).astype(np.float32) * 1e-3
    g = _grads_like(rng)[0]
    jout = (jax.jit(JC.compress_with_feedback) if jitted else JC.compress_with_feedback)(
        jnp.asarray(g), jnp.asarray(err))
    tout = TC.compress_with_feedback(torch.from_numpy(g), torch.from_numpy(err), jitted=jitted)
    for a, b in zip(tout, jout):
        assert np.array_equal(_bits(a.numpy()), _bits(b))


def test_eager_and_jitted_scales_differ_somewhere():
    """The two flavours are not the same function: over a sweep of maxima
    some scale differs by an ulp, so both must be held."""
    amax = np.linspace(0.1, 10.0, 2000, dtype=np.float32)
    eager = amax / np.float32(127.0)
    jitted = amax * np.float32(np.float32(1.0) / np.float32(127.0))
    assert (eager != jitted).any()
    for a in amax[eager != jitted][:5]:
        g = np.array([a, -a / 3], np.float32)
        for jit in (False, True):
            _, js = (jax.jit(JC.int8_compress) if jit else JC.int8_compress)(jnp.asarray(g))
            _, ts = TC.int8_compress(torch.from_numpy(g), jitted=jit)
            assert np.float32(ts).view(np.int32) == np.float32(js).view(np.int32)


def test_fake_compress_grads_has_jitted_reference_bits():
    rng = np.random.default_rng(8)
    tree = {f"g{i}": g for i, g in enumerate(_grads_like(rng))}
    tree["small"] = rng.standard_normal(1023).astype(np.float32)  # < 1,024 values pass
    tree["scalar"] = np.float32(2.5)
    want = jax.jit(JC.fake_compress_grads)({k: jnp.asarray(v) for k, v in tree.items()})
    tt = {k: torch.as_tensor(v) for k, v in tree.items()}
    got = TC.fake_compress_grads(tt, jitted=True)
    for k in tree:
        assert np.array_equal(_bits(got[k].numpy()), _bits(np.asarray(want[k]))), k
        assert np.array_equal(_bits(tt[k].numpy()), _bits(tree[k])), k  # input kept
    assert torch.equal(got["small"], tt["small"])


def test_topk_roundtrip_has_reference_bits_with_ties():
    rng = np.random.default_rng(9)
    g = np.round(rng.standard_normal((40, 25)), 1).astype(np.float32)  # many ties
    jv, ji, jshape = JC.topk_compress(jnp.asarray(g), 0.05)
    tv, ti, tshape = TC.topk_compress(torch.from_numpy(g), 0.05)
    assert tuple(tshape) == tuple(jshape)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(TC.topk_decompress(tv, ti, tshape).numpy(),
                          np.asarray(JC.topk_decompress(jv, ji, jshape)))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_lm_batches_bitwise(seed):
    jmake = jpipe.synthetic_lm_batches(300, 3, 17, seed=seed, n_steps=4)
    tmake = tpipe.synthetic_lm_batches(300, 3, 17, seed=seed, n_steps=4)
    for step in range(4):
        a, b = jmake(step), tmake(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert jmake(4) is None and tmake(4) is None


# ---------------------------------------------------------------------------
# logical axes and abstract params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma-2b", "olmoe-1b-7b", "zamba2-7b"])
def test_abstract_params_and_logical_axes_equal_reference(arch):
    j, t = jget_config(arch), tget_config(arch)
    ja = jax.tree_util.tree_leaves_with_path(JT.abstract_params(j))
    ta = list(leaves(TT.abstract_params(t)))
    assert [tuple(x.shape) for _, x in ja] == [tuple(x.shape) for _, x in ta]
    assert [str(x.dtype) for _, x in ja] == [str(x.dtype).replace("torch.", "") for _, x in ta]
    assert all(x.device.type == "meta" for _, x in ta)
    from repro.distributed.sharding import is_logical_leaf

    jl = jax.tree_util.tree_leaves(JT.logical_axes(j), is_leaf=is_logical_leaf)
    assert jl == [x for _, x in leaves(TT.logical_axes(t))]


def test_train_settings_are_the_reference_fields():
    assert [f.name for f in dataclasses.fields(TLM.TrainSettings)] == [
        f.name for f in dataclasses.fields(JLM.TrainSettings)]
    assert TLM.TrainSettings() == TLM.TrainSettings(**dataclasses.asdict(JLM.TrainSettings()))
