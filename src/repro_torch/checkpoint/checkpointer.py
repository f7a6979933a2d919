"""Fault-tolerant checkpointing: atomic, step-indexed, resumable (PyTorch
port of ``repro.checkpoint.checkpointer``).

Every ``interval`` steps the train state (parameters, optimizer state, step
counter) is flattened and written to ``<dir>/step_<n>.npz`` through a temp
file and a rename (atomic on POSIX), then checkpoints beyond ``keep`` are
deleted. ``restore_latest`` skips torn or corrupt files (a killed writer)
and falls back to the newest readable checkpoint: the property the
supervisor's crash-restart relies on.

The keys are the reference's ``_flatten`` paths (``params/decoder/b0/attn/
wq``, ``opt/count``). numpy has no bf16 without ``ml_dtypes``, so a bf16
leaf is stored as its uint16 bit pattern under ``<key>@bfloat16`` and
restored bit for bit; every other leaf is stored as its numpy array.

A sharded state (DTensor leaves over a ``DeviceMesh``) is saved whole, as
the reference saves its global arrays: every rank gathers each leaf and
rank 0 writes the file, then the ranks meet at a barrier. ``restore``
places each leaf into its template's layout: a DTensor template's
placements on its mesh (each rank keeps its block), a plain tensor's
device.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"step_(\d+)\.npz$")
BF16_TAG = "@bfloat16"


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{path: leaf}`` over a nested dict, paths joined by ``/``."""
    if isinstance(tree, dict):
        flat = {}
        for k in sorted(tree):
            flat.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return flat
    return {prefix: tree}


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _to_numpy(x: torch.Tensor) -> Tuple[str, np.ndarray]:
    """(key suffix, array): a bf16 tensor as its uint16 bits; a DTensor
    gathered whole."""
    if _is_dtensor(x):
        from repro_torch.parallel.collectives import full_tensor
        x = full_tensor(x)
    x = torch.as_tensor(x).detach().cpu()
    if x.dtype == torch.bfloat16:
        return BF16_TAG, x.view(torch.int16).numpy().view(np.uint16)
    return "", x.numpy()


def save(ckpt_dir: str, step: int, state: Any, *, keep: int = 3) -> str:
    """Write ``state`` as ``<ckpt_dir>/step_<step>.npz`` atomically and keep
    the newest ``keep`` checkpoints (all with ``keep=0``). Returns the
    path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {}
    leaves = _flatten(state)
    for key, leaf in leaves.items():
        tag, arr = _to_numpy(leaf)
        flat[key + tag] = arr
    flat["__step__"] = np.asarray(step, np.int64)
    final = os.path.join(ckpt_dir, f"step_{step}.npz")
    if any(_is_dtensor(x) for x in leaves.values()):
        import torch.distributed as dist
        if dist.get_rank() == 0:
            _write(ckpt_dir, final, flat, keep)
        dist.barrier()
        return final
    _write(ckpt_dir, final, flat, keep)
    return final


def _write(ckpt_dir: str, final: str, flat: dict, keep: int) -> None:
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)  # atomic
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _gc(ckpt_dir, keep)


def _gc(ckpt_dir: str, keep: int):
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep] if keep else []:
        try:
            os.unlink(os.path.join(ckpt_dir, f"step_{s}.npz"))
        except OSError:
            pass


def list_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for fn in os.listdir(ckpt_dir):
        m = _STEP_RE.search(fn)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def place_like(x: torch.Tensor, tmpl) -> Any:
    """A whole tensor ``x`` in the layout of the template leaf ``tmpl``: a
    DTensor's placements on its mesh (this rank's block), an abstract
    ``Sharded`` leaf's spec on its ``DeviceMesh``, or a tensor's device;
    in the template's dtype."""
    from repro_torch.models.param import Sharded, distribute, spec_of
    if _is_dtensor(tmpl):
        mesh = tmpl.device_mesh
        return distribute(x.to(device=mesh.device_type, dtype=tmpl.dtype),
                          spec_of(tmpl), mesh)
    if isinstance(tmpl, Sharded):
        return distribute(x.to(device=tmpl.mesh.device_type, dtype=tmpl.dtype), tmpl.spec,
                          tmpl.mesh)
    tmpl = torch.as_tensor(tmpl)
    return x.to(device=tmpl.device, dtype=tmpl.dtype)


def restore(ckpt_dir: str, step: int, state_template: Any) -> Any:
    """The checkpoint of ``step`` in the template's structure, each leaf in
    the template leaf's dtype and layout (:func:`place_like`). Raises if
    the file is unreadable or a key is missing."""
    path = os.path.join(ckpt_dir, f"step_{step}.npz")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}

    def load(tmpl, key):
        if isinstance(tmpl, dict):
            return {k: load(tmpl[k], f"{key}/{k}" if key else str(k)) for k in tmpl}
        if key + BF16_TAG in flat:
            t = torch.from_numpy(flat[key + BF16_TAG].view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(flat[key])
        return place_like(t, tmpl)

    return load(state_template, "")


def restore_latest(ckpt_dir: str, state_template: Any) -> Tuple[Optional[int], Any]:
    """Newest readable checkpoint (corrupt files skipped), or (None,
    template)."""
    for step in reversed(list_steps(ckpt_dir)):
        try:
            return step, restore(ckpt_dir, step, state_template)
        except Exception:
            continue  # torn write: fall back to the previous checkpoint
    return None, state_template
