"""Beyond-paper, on the PyTorch port: the precision-aware technique applied
to an assigned LM.

Counterpart of ``examples/precision_sweep_lm.py`` through ``repro_torch``
alone: quantises a reduced gemma-2b per the structural sensitivity policy
(embeddings/norms pinned, projections int8), verifies output agreement vs
full precision, and reports the weight-byte reduction that drives the
roofline memory/collective terms at scale.  On the GPU (``--device cpu``
for the plain path).

    PYTHONPATH=src python examples/torch_precision_sweep_lm.py [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.quantized import default_lm_policy, quantize_lm_params, quantized_fraction


def compare(params, tokens: torch.Tensor, cfg) -> dict:
    """The int8 bake of ``params`` (``default_lm_policy``) against them on
    ``tokens``: the quantised fraction of parameter elements, the top-1
    agreement and the mean total-variation distance of the two forwards'
    next-token distributions."""
    batch = {"tokens": tokens}
    with torch.no_grad():
        base = T.forward(params, batch, cfg)
        qparams = quantize_lm_params(params, default_lm_policy(cfg))
        quant = T.forward(qparams, batch, cfg)
    base_p = torch.softmax(base, dim=-1)
    quant_p = torch.softmax(quant, dim=-1)
    return {"fraction": quantized_fraction(qparams),
            "agree": float((base.argmax(-1) == quant.argmax(-1)).float().mean()),
            "tvd": float(0.5 * (base_p - quant_p).abs().sum(-1).mean())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("gemma-2b").smoke()
    params = T.init_params(0, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen, device=dev, dtype=torch.int32)
    r = compare(params, tokens, cfg)
    print(f"quantised int8 weight fraction : {r['fraction']*100:.1f}% of parameter elements")
    print(f"top-1 agreement fp32 vs W8     : {r['agree']*100:.1f}%")
    print(f"mean TV distance               : {r['tvd']:.4f}")
    # random-init logits are near-uniform, so argmax agreement is a noisy
    # metric at smoke scale; 0.8 catches real divergence (trained detectors
    # are held to <2.5pp accuracy in benchmarks/bench_table2).
    assert r["agree"] > 0.8, "int8 weight-only quantisation diverged"
    print("OK")


if __name__ == "__main__":
    main()
