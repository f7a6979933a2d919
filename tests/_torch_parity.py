"""Exact structural equality of a port result and the JAX package's.

The two packages define their own dataclasses (``FleetResult``,
``RoutingDecision``, ``FaultRecord``, ...), so ``==`` across them is False
even when every field agrees. :func:`assert_same` walks both values
together — dataclass fields by name and order, dict keys in order, list
items, numpy arrays by dtype, shape and value — and fails at the first
difference with its path. Floats compare with ``==``: no tolerance.
"""

import dataclasses
import math

import numpy as np

_PRIMITIVE = (bool, int, float, str, type(None))


def _primitive_seq(xs) -> bool:
    return all(type(x) in _PRIMITIVE for x in xs)


def assert_same(got, want, path: str = "result") -> None:
    if dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert dataclasses.is_dataclass(got), path
        assert type(got).__name__ == type(want).__name__, path
        names = [f.name for f in dataclasses.fields(want)]
        assert [f.name for f in dataclasses.fields(got)] == names, path
        for name in names:
            assert_same(getattr(got, name), getattr(want, name),
                        f"{path}.{name}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        if _primitive_seq(want.values()) and _primitive_seq(got.values()) \
                and got == want:
            return
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want), path
        assert len(got) == len(want), (path, len(got), len(want))
        if _primitive_seq(want) and _primitive_seq(got) and got == want:
            return
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got), path
    else:
        assert type(got) is type(want), (path, type(got), type(want))
        assert got == want, (path, got, want)
