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
(``provisioning.batched``).

:func:`make_device_mesh` builds the ``torch.distributed`` ``DeviceMesh``
a sharded step runs over (the counterpart of :func:`make_local_mesh` on
real devices): axes ``("data", "model")``, NCCL on the card and gloo on
the CPU, one process a rank. Under ``torchrun`` it joins the world the
launcher set up (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``); alone it
starts a world of one process. :func:`layout_of` is a ``DeviceMesh``'s
:class:`MeshLayout`. The sharded step covers the archs whose blocks are
plain self attention with a dense or MoE FFN; the others wait for ROADMAP
Queue 1 item 4d.
"""

from __future__ import annotations

import math
import os
import socket
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.device import resolve_device


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


def layout_of(mesh) -> MeshLayout:
    """The :class:`MeshLayout` of a ``DeviceMesh`` (its dim names and
    sizes), or the layout itself."""
    if isinstance(mesh, MeshLayout):
        return mesh
    return MeshLayout(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


# ``mesh_axis_sizes`` and ``dp_axes`` are the reference's counterparts,
# held against them by the tests. Neither package's steps call them: the
# rules name their axes themselves and ``MeshCtx`` reads the mesh's sizes.
def mesh_axis_sizes(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh`` or a :class:`MeshLayout`."""
    return dict(layout_of(mesh).shape)


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in layout_of(mesh).axis_names else ("data",)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_device_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A ``DeviceMesh`` of ``data x model`` ranks, axes ``("data",
    "model")``, over the process group that is running, or over a new one:
    NCCL when ``device`` is the card (each rank on ``cuda:LOCAL_RANK``),
    gloo on the CPU. Under ``torchrun`` the group is the launcher's world
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``); without it,
    a world of one process on a free local port. Raises where the world's
    size is not ``data * model`` or a running group has the other backend:
    nothing falls back from one backend to the other."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if world != data * model:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks; the world "
                         f"has {world}")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                    world_size=1, rank=0)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"a {dist.get_backend()} process group is running; a mesh on "
                           f"{dev.type} needs {backend}")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))
