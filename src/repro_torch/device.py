"""Where the port's entry points run: the CUDA card unless the caller asks
for the CPU."""

from __future__ import annotations

from typing import List

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


def resolve_devices(devices) -> List[torch.device]:
    """The devices a member-sharded run uses (the counterpart of the JAX
    package's ``launch.mesh.data_mesh``), each resolved by
    :func:`resolve_device`; a bare ``"cuda"`` is the current card. Raises
    for an empty sequence and for a CUDA index past the visible cards."""
    if isinstance(devices, (str, torch.device)):
        raise TypeError(f"devices must be a sequence of devices, got "
                        f"{devices!r}; pass device= for one device")
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda":
            index = torch.cuda.current_device() if dev.index is None else dev.index
            if not 0 <= index < torch.cuda.device_count():
                raise ValueError(
                    f"device {d!r} does not exist: {torch.cuda.device_count()} "
                    f"CUDA device(s) visible")
            dev = torch.device("cuda", index)
        out.append(dev)
    if not out:
        raise ValueError("devices is empty")
    return out
