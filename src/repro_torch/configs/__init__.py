"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the exact published configuration;
``get_config(name).smoke()`` returns the reduced same-family config used by
CPU smoke tests.  The port's copy of ``repro/configs``: the same names,
aliases and published numbers.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "shield8_cnn",
    "phi35_moe",
    "olmoe_1b_7b",
    "phi4_mini",
    "gemma3_12b",
    "h2o_danube3_4b",
    "gemma_2b",
    "rwkv6_7b",
    "zamba2_7b",
    "hubert_xlarge",
    "internvl2_1b",
]

#: assignment-pool ids -> module names
ALIASES = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "phi4-mini-3.8b": "phi4_mini",
    "gemma3-12b": "gemma3_12b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "gemma-2b": "gemma_2b",
    "rwkv6-7b": "rwkv6_7b",
    "zamba2-7b": "zamba2_7b",
    "hubert-xlarge": "hubert_xlarge",
    "internvl2-1b": "internvl2_1b",
    "shield8-cnn": "shield8_cnn",
}


def get_config(name: str):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", ""))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def lm_arch_names() -> list[str]:
    return [a for a in ALIASES if a != "shield8-cnn"]
