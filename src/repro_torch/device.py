"""Where the port's entry points run: the CUDA card unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    passes ``device="cpu"``. Raises when CUDA is asked for (explicitly or by
    default) and absent — the port never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on the CUDA card by default and no CUDA device is "
            "available; pass device='cpu' to run the kernels' plain PyTorch "
            "versions on the CPU")
    return dev
