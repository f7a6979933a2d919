"""Architecture registry (PyTorch port of ``repro.configs``).

This slice carries the paper's evaluation workload, BLOOM-176B, whose
roofline terms set the power plane of the Table-4 mix. The other
architectures come with the serving slice.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ALL = {
    "bloom-176b": "bloom_176b",
}


def get_config(name: str) -> ModelConfig:
    if name not in ALL:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALL)}")
    mod = importlib.import_module(f"repro_torch.configs.{ALL[name]}")
    return mod.CONFIG
