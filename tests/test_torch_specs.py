"""The dry run's shape cells and abstract trees against the JAX package.

For every architecture and shape cell, ``launch/specs.py``'s skips, batch
stand-ins (shapes, dtypes, logical axes) and cache stand-ins equal the
reference's, with a model axis of 16 and of 2; the abstract and logical
parameter trees (``abstract_from_specs``, ``logical_from_specs``), the
quantised ones (``abstract_quantized``) and ``cache_logical_axes`` equal
the reference's leaf for leaf.  Everything is compared exactly.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as JC  # noqa: E402
from repro.core.quantization import QTensor as JQ  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import quantized as JQM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as PC  # noqa: E402
from repro_torch.core.quantization import QTensor as PQ  # noqa: E402
from repro_torch.launch import specs as PS  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import quantized as PQM  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

ARCHS = PC.lm_arch_names()


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def abstract(tree):
    """A tree of stand-ins as nested dicts of ``(shape, dtype name)``; a
    ``QTensor`` as ``("QTensor", q, scale, axis)``."""
    if isinstance(tree, dict):
        return {k: abstract(v) for k, v in tree.items()}
    if isinstance(tree, (JQ, PQ)):
        return ("QTensor", abstract(tree.q), abstract(tree.scale), tree.axis)
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta", tree.device
    return (tuple(int(s) for s in tree.shape), _dtype(tree.dtype))


def logical(tree):
    if isinstance(tree, dict):
        return {k: logical(v) for k, v in tree.items()}
    if isinstance(tree, (JQ, PQ)):
        return ("QTensor", logical(tree.q), logical(tree.scale), tree.axis)
    return tuple(tree)


def test_archs_and_shapes_are_the_references():
    assert ARCHS == JC.lm_arch_names()
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in PS.SHAPES.items()} == {
        k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in JS.SHAPES.items()}
    assert (PS.SHAPES["train_4k"].seq_len, PS.SHAPES["train_4k"].global_batch) == (4096, 256)
    assert (PS.SHAPES["long_500k"].seq_len, PS.SHAPES["long_500k"].global_batch) == (524288, 1)


@pytest.mark.parametrize("shape", list(PS.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_specs_equal_reference(arch, shape):
    pcfg, jcfg = PC.get_config(arch), JC.get_config(arch)
    pshape, jshape = PS.SHAPES[shape], JS.SHAPES[shape]
    assert PS.skip_reason(pcfg, pshape) == JS.skip_reason(jcfg, jshape)
    pb, pl = PS.batch_specs(pcfg, pshape)
    jb, jl = JS.batch_specs(jcfg, jshape)
    assert abstract(pb) == abstract(jb)
    assert logical(pl) == logical(jl)
    if pshape.kind != "decode":
        return
    for model in (16, 2):
        pc, pcl = PS.cache_specs(pcfg, pshape, model_axis_size=model)
        jc, jcl = JS.cache_specs(jcfg, jshape, model_axis_size=model)
        assert abstract(pc) == abstract(jc), model
        assert logical(pcl) == logical(jcl), model


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_equal_reference(arch):
    pcfg, jcfg = PC.get_config(arch), JC.get_config(arch)
    pspecs, jspecs = PT.build_specs(pcfg), JT.build_specs(jcfg)
    pa, ja = PL.abstract_from_specs(pspecs, pcfg), JL.abstract_from_specs(jspecs, jcfg)
    assert abstract(pa) == abstract(ja)
    assert logical(PL.logical_from_specs(pspecs)) == logical(JL.logical_from_specs(jspecs))
    assert abstract(PT.abstract_params(pcfg)) == abstract(pa)
    assert logical(PT.logical_axes(pcfg)) == logical(JT.logical_axes(jcfg))
    for seq_axis in ("kv_seq", "kv_seq_model"):
        assert logical(PT.cache_logical_axes(pcfg, seq_axis)) == logical(
            JT.cache_logical_axes(jcfg, seq_axis))
    pq, pql = PQM.abstract_quantized(pa, PT.logical_axes(pcfg), PQM.default_lm_policy(pcfg))
    jq, jql = JQM.abstract_quantized(ja, JT.logical_axes(jcfg), JQM.default_lm_policy(jcfg))
    assert abstract(pq) == abstract(jq)
    assert logical(pql) == logical(jql)
    assert any(isinstance(v, PQ) for v in PL.tree_leaves(pq))
