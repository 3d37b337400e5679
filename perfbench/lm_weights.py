"""The weights of an LM configuration, drawn on the device from the seed.

A reference module (``perfbench/references/<name>.py``) states the model's
leaves: ``global_leaves(conf)`` (path -> (shape, init)), ``pattern(conf)``
(the layer kinds of one period of the depth) and ``layer_leaves(conf,
kind)`` (a layer's leaves by path).  :func:`draw` makes every leaf, each
kind of layer leaf stacked over the layers that hold it, in one
``torch.randn`` call each on a generator on the device: normals of standard
deviation ``conf["initializer_range"]`` (a gain's ``"ones"``: ones), in the
type the configuration is served in (``conf["torch_dtype"]``).  The layout
is plain: layer ``l`` is the ``l // period``-th row of the leaves under
``groups/pos<l % period>/`` (:func:`layer`), which is also where the port's
own params tree keeps it, so :func:`nest` hands the same values to the
port without a copy beyond the dtype its leaves take.
"""
from __future__ import annotations

from typing import Mapping

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def table(ref, conf: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """Every leaf, path -> (shape, init), layer leaves stacked by position."""
    pattern = ref.pattern(conf)
    groups, rest = divmod(conf["num_hidden_layers"], len(pattern))
    if rest:
        raise ValueError(f"{conf['num_hidden_layers']} layers are no whole number of "
                         f"periods of {pattern}")
    out = dict(ref.global_leaves(conf))
    for p, kind in enumerate(pattern):
        for path, (shape, init) in ref.layer_leaves(conf, kind).items():
            out[f"groups/pos{p}/{path}"] = ((groups, *shape), init)
    return out


def draw(ref, conf: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The seeded leaves on ``device`` by path (see the module docstring)."""
    dev = torch.device(device)
    dtype = DTYPES[conf["torch_dtype"]]
    std = float(conf["initializer_range"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for path, (shape, init) in table(ref, conf).items():
        if init == "ones":
            out[path] = torch.ones(shape, dtype=dtype, device=dev)
        elif init == "normal":
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
            out[path] = w.mul_(std).to(dtype)
            del w
        else:
            raise ValueError(f"{path}: unknown init {init!r}")
    return out


def layer(weights: Mapping[str, torch.Tensor], pattern, l: int) -> tuple[str, dict]:
    """Layer ``l``'s kind and leaves by path (views of the stacked leaves)."""
    p, g = l % len(pattern), l // len(pattern)
    prefix = f"groups/pos{p}/"
    return pattern[p], {k[len(prefix):]: v[g] for k, v in weights.items()
                        if k.startswith(prefix)}


def nest(weights: Mapping[str, torch.Tensor], like) -> dict:
    """The leaves as the nested dict ``like`` (a tree of tensors, as the
    port's ``abstract_params`` gives on the ``meta`` device), each cast to
    its dtype; raises where a path or a shape differs."""
    flat = {}

    def walk(tree, path):
        if isinstance(tree, Mapping):
            for k, v in tree.items():
                walk(v, f"{path}/{k}" if path else k)
        else:
            flat[path] = tree

    walk(like, "")
    if set(flat) != set(weights):
        raise ValueError(f"the leaves differ from the program's: "
                         f"{sorted(set(flat) ^ set(weights))}")
    out: dict = {}
    for path, spec in flat.items():
        w = weights[path]
        if tuple(w.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: shape {tuple(w.shape)}, the program's {tuple(spec.shape)}")
        node = out
        *parents, name = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = w.to(spec.dtype)
    return out
