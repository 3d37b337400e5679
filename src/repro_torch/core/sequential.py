"""Sequential shared-datapath execution: one layer body reused L times.

Counterpart of ``repro/core/sequential.py``.  The reference runs the
layers as ``jax.lax.scan`` over layer-stacked parameters, one compiled
body streamed L times.  Eager PyTorch has no compiled body to reuse, so
the counterpart is a Python loop over the unbound layers:

* :func:`stack_layers` stacks a list of same-structure trees along a new
  leading ``layer`` axis (``torch.stack``);
* :func:`unstack_layers` splits such a tree into its layers with
  ``torch.unbind``, whose backward is one stack (a slice ``t[i]`` a layer
  would write a zero-filled copy of the whole stacked tensor for each);
* :func:`scan_layers` and :func:`scan_layers_with_aux` loop the body over
  those layers; ``remat=True`` wraps each call in
  ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``.

Trees are nested dicts, lists and tuples whose leaves are tensors or
``QTensor`` (payload and scale stacked and split alike).

``policy`` names what the rematerialised body keeps, as the reference's
``jax.checkpoint_policies`` do: ``"nothing_saveable"`` (the default of
``jax.checkpoint``: keep only the body's inputs), ``"everything_saveable"``
(keep every intermediate), ``"dots_saveable"`` (keep matmul results) and
``"dots_with_no_batch_dims_saveable"`` (keep the results of matmuls without
batch dimensions), each mapped onto ``torch.utils.checkpoint``'s selective
policy; a callable is taken as such a policy as it is.  Other names raise:
the reference's name-based policies have no counterpart here.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Mapping, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.quantization import QTensor

_MATMULS = ("mm", "addmm", "bmm", "baddbmm", "matmul", "_scaled_mm")
_UNBATCHED_MATMULS = ("mm", "addmm")


def _leaves_map(fn: Callable, *trees):
    """``fn`` over the corresponding leaves of same-structure trees."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _leaves_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_leaves_map(fn, *parts) for parts in zip(*trees))
    if isinstance(first, QTensor):
        return QTensor(fn(*(t.q for t in trees)), fn(*(t.scale for t in trees)), first.axis)
    if first is None:
        return None
    return fn(*trees)


def stack_layers(layer_params: list[Any]):
    """Stack a list of identical trees along a new leading 'layer' axis."""
    return _leaves_map(lambda *xs: torch.stack(xs, dim=0), *layer_params)


def _split(tree) -> list:
    """The layers of a stacked tree, each leaf split once with ``torch.unbind``."""
    if isinstance(tree, Mapping):
        parts = {k: _split(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_split(v) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(len(parts[0]))]
    if isinstance(tree, QTensor):
        return [QTensor(q, s, tree.axis)
                for q, s in zip(torch.unbind(tree.q), torch.unbind(tree.scale))]
    return list(torch.unbind(tree))


def unstack_layers(stacked: Any, n: int) -> list[Any]:
    """The ``n`` layers of a stacked tree.  ``torch.unbind`` splits each
    leaf once, so the backward of all ``n`` layers is one stack."""
    layers = _split(stacked)
    if len(layers) != n:
        raise ValueError(f"unstack_layers: the tree holds {len(layers)} layers, not {n}")
    return layers


def _selective(names: tuple[str, ...]):
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    def policy_fn(ctx, op, *args, **kwargs):
        name = getattr(op, "__name__", str(op)).split(".")[0]
        return (CheckpointPolicy.MUST_SAVE if name in names
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def _remat(body: Callable, policy: Union[str, Callable, None]) -> Callable:
    """``body`` under ``torch.utils.checkpoint`` with ``policy`` (see the
    module docstring)."""
    if policy is None or policy == "nothing_saveable":
        context_fn = None
    elif policy == "everything_saveable":
        return body
    elif policy == "dots_saveable":
        context_fn = _selective(_MATMULS)
    elif policy == "dots_with_no_batch_dims_saveable":
        context_fn = _selective(_UNBATCHED_MATMULS)
    elif callable(policy):
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        context_fn = functools.partial(create_selective_checkpoint_contexts, policy)
    else:
        raise ValueError(f"checkpoint policy {policy!r} has no torch.utils.checkpoint "
                         "counterpart")

    def fn(*args):
        if context_fn is None:
            return checkpoint(body, *args, use_reentrant=False)
        return checkpoint(body, *args, use_reentrant=False, context_fn=context_fn)

    return fn


def scan_layers(
    body: Callable[[Any, Any], Any],
    stacked_params: Any,
    x: Any,
    *,
    unroll: int = 1,
    remat: bool = False,
    policy: Optional[Union[str, Callable]] = None,
) -> Any:
    """Run ``x`` through the L stacked layers one after another on one body.

    ``body(layer_params, x) -> x`` is the one-layer program.  ``remat=True``
    recomputes each layer in the backward pass (``policy`` as in the module
    docstring).  ``unroll`` is accepted for the reference's signature: a
    Python loop is unrolled already.
    """
    del unroll
    fn = _remat(body, policy) if remat else body
    for layer in _split(stacked_params):
        x = fn(layer, x)
    return x


def scan_layers_with_aux(
    body: Callable[[Any, Any], tuple[Any, Any]],
    stacked_params: Any,
    x: Any,
    *,
    remat: bool = False,
) -> tuple[Any, Any]:
    """Like :func:`scan_layers`, but the body also emits a per-layer aux
    output (MoE load-balance stats, per-layer cache slices), returned
    stacked along a leading layer axis."""
    fn = _remat(body, None) if remat else body
    auxes = []
    for layer in _split(stacked_params):
        x, aux = fn(layer, x)
        auxes.append(aux)
    return x, stack_layers(auxes)
