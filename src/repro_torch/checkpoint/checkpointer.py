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


def _to_numpy(x: torch.Tensor) -> Tuple[str, np.ndarray]:
    """(key suffix, array): a bf16 tensor as its uint16 bits."""
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
    for key, leaf in _flatten(state).items():
        tag, arr = _to_numpy(leaf)
        flat[key + tag] = arr
    flat["__step__"] = np.asarray(step, np.int64)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        final = os.path.join(ckpt_dir, f"step_{step}.npz")
        os.replace(tmp, final)  # atomic
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _gc(ckpt_dir, keep)
    return final


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


def restore(ckpt_dir: str, step: int, state_template: Any) -> Any:
    """The checkpoint of ``step`` in the template's structure, each leaf in
    the template leaf's dtype and on its device. Raises if the file is
    unreadable or a key is missing."""
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
        tmpl = torch.as_tensor(tmpl)
        return t.to(device=tmpl.device, dtype=tmpl.dtype)

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
