"""The system under test: the port's deployed detector datapath.

The benchmark takes from the program only this: the artifact baked once by
``repro_torch.serving.quantized_params.quantize_params`` from the seeded
float32 checkpoint (with ``repro_torch.core.pruning.plan_prune`` and
``repro_torch.core.precision_policy.PrecisionPolicy`` as the configuration
states), and ``repro_torch.serving.accelerator.accelerator_forward``, the
entry the window drives.  The port is imported here, when a program is
built, and never by the modules that make inputs or judge outputs.
"""
from __future__ import annotations

import torch


class Program:
    """One configuration's artifact on ``device`` and its forward."""

    def __init__(self, conf: dict, params: dict, device, *, raw: bool):
        from repro_torch.core.precision_policy import PrecisionPolicy
        from repro_torch.core.pruning import plan_prune
        from repro_torch.models.cnn1d import CNNConfig
        from repro_torch.serving.accelerator import accelerator_forward
        from repro_torch.serving.quantized_params import quantize_params

        cnn = conf["cnn"]
        self.cfg = CNNConfig(input_len=cnn["input_len"], channels=tuple(cnn["channels"]),
                             kernel=cnn["kernel"], hidden=cnn["hidden"],
                             n_classes=cnn["n_classes"])
        prune = conf.get("prune")
        spec = None
        if prune:
            last = f"conv{len(cnn['channels']) - 1}"
            spec = plan_prune(params[last]["w"], self.cfg.n_frames, keep=prune["keep"],
                              trim_frames=prune["trim_frames"])
        policy = None
        if conf.get("policy"):
            policy = PrecisionPolicy.parse(conf["policy"], default=conf["precision"])
        self.device = torch.device(device)
        self.raw = raw
        self.artifact = quantize_params(params, self.cfg, mode=conf["precision"], prune=spec,
                                        policy=policy, feature_kind=conf["feature_kind"],
                                        device=self.device)
        self._forward = accelerator_forward

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        """(B, input_len) feature rows, or (B, 12800) raw windows, on the
        device -> (B, n_classes) probabilities on the device."""
        return self._forward(self.artifact, rows, self.cfg, device=self.device,
                             raw_windows=self.raw)
