"""Mesh layouts (PyTorch port of ``repro.launch.mesh``).

A :class:`MeshLayout` is a frozen record of named axes and their sizes: the
twin of JAX's ``AbstractMesh``. It touches no device and no process group;
the dry run (``launch.dryrun``) lays parameters, optimizer state, inputs and
caches out over it (``models.param.resolve_spec``, ``shard_shape``) and
counts each device's bytes and collectives from that layout alone.

The reference's ``set_mesh`` and ``shard_map_compat`` are shims over JAX
versions (``jax.set_mesh`` / ``use_mesh``, ``jax.shard_map`` /
``check_rep``) and have no counterpart: nothing here enters a mesh context
or maps a function over shards. ``data_mesh`` (the batched engine's member
axis) has none either; the port shards members over a list of devices
(``provisioning.batched``). Running a step over a ``torch.distributed``
``DeviceMesh`` is ROADMAP Queue 1 item 4c.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class MeshLayout:
    """Named mesh axes and their sizes, outermost first."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.axis_sizes} differ "
                             f"in length")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.axis_sizes)

    @property
    def label(self) -> str:
        """``"16x16"``, ``"2x16x16"``: the dry run's ``mesh`` key."""
        return "x".join(str(n) for n in self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``."""
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 0) -> MeshLayout:
    """A small layout (tests, the card's own 1 x 1)."""
    if pod:
        return MeshLayout(("pod", "data", "model"), (pod, data, model))
    return MeshLayout(("data", "model"), (data, model))


# ``mesh_axis_sizes`` and ``dp_axes`` have no caller in the port yet: they
# are the reference's counterparts, held against them by the tests, for the
# sharded step (ROADMAP Queue 1 item 4c).
def mesh_axis_sizes(mesh: MeshLayout) -> dict:
    return dict(mesh.shape)


def dp_axes(mesh: MeshLayout) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
