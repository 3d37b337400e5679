"""The port's sequential helpers against ``repro.core.sequential``.

A small seeded body (``tanh(x @ w + b) * g``, fp32, weights and input from
a numpy generator) runs through four stacked layers in both packages:
``stack_layers``/``unstack_layers`` round trips, ``scan_layers`` forward
and gradient (with respect to the stacked params and the input), with and
without ``remat`` and under each checkpoint policy the port maps, and
``scan_layers_with_aux``'s carry and stacked aux.  Limit: 1e-6 of each
leaf's largest magnitude (or absolute, below 1): the reference's XLA and
the port's BLAS sum the matmuls in different orders, which costs a few
fp32 ulps (1.4e-6 at gradients near 5, 5.5e-7 of them).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import sequential as JS  # noqa: E402
from repro_torch.core import sequential as PS  # noqa: E402
from repro_torch.core.quantization import QTensor  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-6
N_LAYERS, D, B = 4, 8, 3


def layers_np(seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32),
             "b": rng.standard_normal(D).astype(np.float32) * 0.1,
             "g": {"scale": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)}}
            for _ in range(N_LAYERS)]


def x_np(seed=1):
    return np.random.default_rng(seed).standard_normal((B, D)).astype(np.float32)


def jbody(p, x):
    return jnp.tanh(x @ p["w"] + p["b"]) * p["g"]["scale"]


def pbody(p, x):
    return torch.tanh(x @ p["w"] + p["b"]) * p["g"]["scale"]


def jbody_aux(p, x):
    y = jbody(p, x)
    return y, {"mean": y.mean(axis=0), "sq": (y * y).sum()}


def pbody_aux(p, x):
    y = pbody(p, x)
    return y, {"mean": y.mean(dim=0), "sq": (y * y).sum()}


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k])
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL * max(1.0, float(np.abs(want).max(initial=0))))


def test_stack_and_unstack_equal_reference():
    ls = layers_np()
    jst = JS.stack_layers([jax.tree_util.tree_map(jnp.asarray, p) for p in ls])
    pst = PS.stack_layers([to_torch(p) for p in ls])
    close(pst, jax.tree_util.tree_map(np.asarray, jst))
    for got, want in zip(PS.unstack_layers(pst, N_LAYERS), JS.unstack_layers(jst, N_LAYERS)):
        close(got, jax.tree_util.tree_map(np.asarray, want))
    with pytest.raises(ValueError, match="holds 4 layers"):
        PS.unstack_layers(pst, 3)


def test_stack_and_unstack_carry_qtensor_payload_and_scale():
    q = [QTensor(torch.full((2, 3), i, dtype=torch.int8), torch.full((1, 3), float(i)), 1)
         for i in range(3)]
    st = PS.stack_layers([{"w": t} for t in q])
    assert st["w"].q.shape == (3, 2, 3) and st["w"].scale.shape == (3, 1, 3) and st["w"].axis == 1
    back = PS.unstack_layers(st, 3)
    assert all(torch.equal(b["w"].q, t.q) and torch.equal(b["w"].scale, t.scale)
               for b, t in zip(back, q))


def test_unstack_backward_is_one_stack():
    """``unbind``'s backward stacks the layers' gradients once; a slice per
    layer would scatter each into a zero-filled copy of the whole stack."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func._schema.name.split("::")[-1])
            return func(*args, **(kwargs or {}))

    st = PS.stack_layers([to_torch(p) for p in layers_np()])
    leaves = {"w": st["w"].requires_grad_(True)}
    loss = sum((layer["w"] ** 2).sum() for layer in PS.unstack_layers(leaves, N_LAYERS))
    with Ops() as ops:
        (g,) = torch.autograd.grad(loss, [leaves["w"]])
    assert ops.names.count("stack") == 1
    assert "select_backward" not in ops.names and "zeros" not in ops.names
    torch.testing.assert_close(g, 2 * st["w"].detach(), rtol=0, atol=0)


def _jax_scan(remat, policy):
    def f(stacked, x):
        out = JS.scan_layers(jbody, stacked, x, remat=remat, policy=policy)
        return (out ** 2).sum(), out

    return jax.value_and_grad(f, argnums=(0, 1), has_aux=True)


def _port_scan(stacked_np, x, remat, policy):
    leaves = to_torch(stacked_np)
    flat = [leaves["w"], leaves["b"], leaves["g"]["scale"]]
    for t in flat:
        t.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = PS.scan_layers(pbody, leaves, xt, remat=remat, policy=policy)
    loss = (out ** 2).sum()
    gw, gb, gs, gx = torch.autograd.grad(loss, flat + [xt])
    return loss, out, {"w": gw, "b": gb, "g": {"scale": gs}}, gx


POLICIES = {
    None: None,
    "nothing_saveable": jax.checkpoint_policies.nothing_saveable,
    "everything_saveable": jax.checkpoint_policies.everything_saveable,
    "dots_saveable": jax.checkpoint_policies.dots_saveable,
    "dots_with_no_batch_dims_saveable": jax.checkpoint_policies.dots_with_no_batch_dims_saveable,
}


@pytest.mark.parametrize("remat,policy", [(False, None)] + [(True, p) for p in POLICIES])
def test_scan_layers_forward_and_gradient_equal_reference(remat, policy):
    ls = layers_np()
    x = x_np()
    jst = JS.stack_layers([jax.tree_util.tree_map(jnp.asarray, p) for p in ls])
    (jloss, jout), (jgp, jgx) = _jax_scan(remat, POLICIES[policy])(jst, jnp.asarray(x))
    stacked_np = jax.tree_util.tree_map(np.asarray, jst)
    loss, out, gp, gx = _port_scan(stacked_np, x, remat, policy)
    close(out, jout)
    assert abs(float(loss.detach()) - float(jloss)) <= ATOL * max(1.0, abs(float(jloss)))
    close(gp, jax.tree_util.tree_map(np.asarray, jgp))
    close(gx, jgx)


def test_remat_changes_no_bit_and_unknown_policy_raises():
    stacked_np = jax.tree_util.tree_map(
        np.asarray, JS.stack_layers([jax.tree_util.tree_map(jnp.asarray, p)
                                     for p in layers_np()]))
    x = x_np()
    plain = _port_scan(stacked_np, x, False, None)
    for policy in POLICIES:
        again = _port_scan(stacked_np, x, True, policy)
        assert torch.equal(again[1], plain[1]) and torch.equal(again[3], plain[3])
    with pytest.raises(ValueError, match="no torch.utils.checkpoint counterpart"):
        _port_scan(stacked_np, x, True, "save_only_these_names")


@pytest.mark.parametrize("remat", [False, True])
def test_scan_layers_with_aux_equal_reference(remat):
    ls = layers_np(3)
    x = x_np(4)
    jst = JS.stack_layers([jax.tree_util.tree_map(jnp.asarray, p) for p in ls])

    def jf(stacked, xx):
        out, aux = JS.scan_layers_with_aux(jbody_aux, stacked, xx, remat=remat)
        return out.sum() + aux["sq"].sum(), (out, aux)

    (_, (jout, jaux)), jg = jax.value_and_grad(jf, has_aux=True)(jst, jnp.asarray(x))
    leaves = to_torch(jax.tree_util.tree_map(np.asarray, jst))
    flat = [leaves["w"], leaves["b"], leaves["g"]["scale"]]
    for t in flat:
        t.requires_grad_(True)
    out, aux = PS.scan_layers_with_aux(pbody_aux, leaves, torch.from_numpy(x), remat=remat)
    gw, gb, gs = torch.autograd.grad(out.sum() + aux["sq"].sum(), flat)
    close(out, jout)
    close(aux, jax.tree_util.tree_map(np.asarray, jaux))
    assert aux["mean"].shape == (N_LAYERS, D) and aux["sq"].shape == (N_LAYERS,)
    close({"w": gw, "b": gb, "g": {"scale": gs}}, jax.tree_util.tree_map(np.asarray, jg))
