"""Shared stdlib-logging setup for the launchers (port of
``repro.obs.log``; DESIGN.md §14).

One configuration point for everything under the ``repro_torch`` logger
namespace: a stderr ``StreamHandler`` with a bare ``%(message)s``
formatter (so output text at the default level is byte-identical to the
``print()`` calls it replaced — only the stream moves, stdout stays clean
for CSV/JSONL), and a level taken from the reference's
``REPRO_LOG_LEVEL`` environment variable (``DEBUG`` / ``INFO`` /
``WARNING`` / ``ERROR``; default ``INFO``).

Usage::

    from repro_torch.obs.log import get_logger
    log = get_logger(__name__)
    log.info("arch=%s params=%.1fM", cfg.name, n_params / 1e6)
"""

from __future__ import annotations

import logging
import os
import sys

ENV_VAR = "REPRO_LOG_LEVEL"
_ROOT = "repro_torch"
_configured = False


def setup_logging(level: str | int | None = None, *,
                  stream=None, force: bool = False) -> logging.Logger:
    """Configure the ``repro_torch`` logger once (idempotent unless
    ``force``): stderr handler, message-only format, ``REPRO_LOG_LEVEL`` env
    level. Returns the root ``repro_torch`` logger."""
    global _configured
    root = logging.getLogger(_ROOT)
    if _configured and not force:
        return root
    if level is None:
        level = os.environ.get(ENV_VAR, "INFO").upper()
    if isinstance(level, str):
        level = getattr(logging, level, logging.INFO)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
    handler.setFormatter(logging.Formatter("%(message)s"))
    root.addHandler(handler)
    root.setLevel(level)
    root.propagate = False  # keep the global root logger out of the path
    _configured = True
    return root


def get_logger(name: str) -> logging.Logger:
    """A logger under the shared ``repro_torch`` namespace, configuring the
    stderr handler on first use. ``name`` outside the namespace is nested
    under it (``repro_torch.<name>``) so the one handler covers everything."""
    setup_logging()
    if name != _ROOT and not name.startswith(_ROOT + "."):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
