"""Roofline terms of a dry-run cell (PyTorch port of
``repro.parallel.roofline``).

Three terms per (arch x shape x mesh) cell, in seconds, on the constants of
a :class:`Chip` (default :data:`H100`):

  compute    = flops_per_device / peak_flops
  memory     = hbm_bytes_per_device / hbm_bw
  collective = collective_bytes_per_device / link_bw

The FLOPs and HBM bytes are ``parallel.analytic.step_cost``'s. The port's
attention kernels never write the attention scores to memory, so the HBM
term never adds ``attn_score_bytes`` (the reference's ``use_pallas``
accounting). The collective bytes are the bytes each device sends on the
wire, from the ring cost of each collective (:func:`ring_bytes`):

  all-gather:         R * (n-1)/n        (R = full gathered result bytes)
  reduce-scatter:     R * (n-1)          (R = scattered result bytes; operand = R*n)
  all-reduce:         2 * R * (n-1)/n    (RS + AG phases)
  all-to-all:         R * (n-1)/n
  collective-permute: R

There is no compiled HLO to parse here: the dry run (``launch.dryrun``)
derives each cell's collectives from its sharding rules and costs them with
these formulas.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass(frozen=True)
class Chip:
    """One accelerator's roofline constants."""

    name: str
    peak_flops: float  # dense FLOP/s of the step's compute type
    hbm_bw: float  # bytes/s
    hbm_bytes: float  # device memory
    link_bw: float  # bytes/s one device sends on the link its collectives ride
    node_devices: int = 0  # devices joined by link_bw (0: no limit)
    node_link_bw: float = 0.0  # bytes/s one device sends to another node

    def for_devices(self, n_devices: int) -> "Chip":
        """The constants a mesh of ``n_devices`` sees: past ``node_devices``
        a ring crosses nodes, and every hop runs at the slowest link's
        rate, ``node_link_bw``."""
        if self.node_devices and n_devices > self.node_devices:
            return dataclasses.replace(self, name=f"{self.name}, across nodes",
                                       link_bw=self.node_link_bw)
        return self


# NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU data sheet): dense
# BF16 tensor-core 989 TFLOP/s (1979 is with 2:4 sparsity), HBM3 3.35 TB/s,
# 80 GB. NVLink 4 gives a GPU 900 GB/s in both directions together, 450
# GB/s each way: the rate of a ring whose devices sit in one 8-GPU NVLink
# node, i.e. any mesh of at most 8 devices (the (2, 4) test layout). A mesh
# of 256 or 512 such GPUs is 32 or 64 nodes, and each 16-wide axis of the
# production layouts spans at least two of them: there a ring runs at the
# node's network rate, one 400 Gb/s NDR InfiniBand port a GPU (DGX H100
# data sheet: eight ConnectX-7 ports), 50 GB/s each way, 9x below NVLink.
H100 = Chip(name="NVIDIA H100 SXM5 80GB", peak_flops=989e12, hbm_bw=3.35e12,
            hbm_bytes=80e9, link_bw=450e9, node_devices=8, node_link_bw=50e9)


def ring_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Bytes one device sends in a ring collective of ``n`` devices whose
    result holds ``result_bytes`` bytes a device."""
    r = result_bytes
    if kind == "all-gather":
        return r * (n - 1) / n
    if kind == "reduce-scatter":
        return r * (n - 1)
    if kind == "all-reduce":
        return 2 * r * (n - 1) / n
    if kind == "all-to-all":
        return r * (n - 1) / n
    if kind == "collective-permute":
        return r
    raise ValueError(f"unknown collective {kind!r}")


@dataclass
class CollectiveStats:
    ops: Dict[str, int] = field(default_factory=dict)  # op kind -> count
    bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    total_bytes: float = 0.0  # per-device bytes on the wire

    def add(self, kind: str, result_bytes: float, n: int, count: int = 1) -> None:
        """``count`` collectives of ``kind`` over ``n`` devices whose results
        hold ``result_bytes`` bytes a device in all. A group of one device
        sends nothing and is not counted."""
        if n <= 1 or count <= 0:
            return
        b = ring_bytes(kind, result_bytes, n)
        self.ops[kind] = self.ops.get(kind, 0) + count
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + b
        self.total_bytes += b


@dataclass
class Roofline:
    flops_per_device: float  # analytic (exact; see parallel/analytic.py)
    hbm_bytes_per_device: float  # analytic traffic lower bound
    collective_bytes_per_device: float  # derived from the sharding rules
    model_flops_global: float  # 6*N*D (train) / 2*N*D (inference), active params
    n_devices: int
    collectives: Optional[CollectiveStats] = None
    # the traced step's counts (launch.dryrun): FLOPs under FlopCounterMode,
    # bytes every eager op reads and writes
    hlo_flops_per_device: float = 0.0
    hlo_bytes_per_device: float = 0.0
    kind: str = "train"  # train | prefill | decode
    chip: Chip = H100

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.chip.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / self.chip.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / self.chip.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Lower-bound step time: perfectly-overlapped roofline."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / analytic FLOPs (global) — catches remat/redundancy waste."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops_global / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """How close the cell sits to its NATURAL roofline: compute-bound for
        train/prefill (t_compute / t_bound), memory-bound for decode
        (t_memory / t_bound; decode must stream weights+KV, so the memory
        term IS the ideal). 1.0 = at the roofline."""
        t = self.t_bound
        if t <= 0:
            return 0.0
        ideal = self.t_memory if self.kind == "decode" else self.t_compute
        return ideal / t

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound."""
        t = self.t_bound
        if t <= 0:
            return 0.0
        return (self.model_flops_global / self.n_devices / t) / self.chip.peak_flops

    def to_dict(self) -> dict:
        d = {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "hlo_flops_per_device": self.hlo_flops_per_device,
            "hlo_bytes_per_device": self.hlo_bytes_per_device,
            "model_flops_global": self.model_flops_global,
            "n_devices": self.n_devices,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "kind": self.kind,
            "roofline_fraction": self.roofline_fraction,
        }
        if self.collectives:
            d["collective_ops"] = self.collectives.ops
            d["collective_bytes_by_kind"] = self.collectives.bytes_by_kind
        return d


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference) with
    N = active params (MoE-aware)."""
    n = cfg.active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def extrapolate_collectives(st1: CollectiveStats, st2: CollectiveStats,
                            groups: int) -> CollectiveStats:
    """Linear extrapolation from 1-group/2-group counts to ``groups``.

    The dry run derives its collectives at full depth and does not call
    this; it is the reference's counterpart, held against it by the tests."""
    out = CollectiveStats()
    kinds = set(st1.ops) | set(st2.ops)
    for k in kinds:
        c1, c2 = st1.ops.get(k, 0), st2.ops.get(k, 0)
        b1, b2 = st1.bytes_by_kind.get(k, 0.0), st2.bytes_by_kind.get(k, 0.0)
        # clamp at the 1-group floor, as the reference does
        out.ops[k] = max(c1, c1 + (groups - 1) * (c2 - c1), 0)
        out.bytes_by_kind[k] = max(0.0, b1 + (groups - 1) * (b2 - b1))
        out.total_bytes += out.bytes_by_kind[k]
    return out


def build_roofline(cfg, shape, n_devices: int, enc_S: int, dec_S: int,
                   collectives: CollectiveStats, *, traced_flops_per_device: float = 0.0,
                   traced_bytes_per_device: float = 0.0) -> Roofline:
    """The cell's roofline on the H100 a mesh of ``n_devices`` sees
    (``H100.for_devices``): analytic FLOPs and HBM bytes a device
    (``step_cost`` over ``n_devices``, no score bytes), the derived
    collectives, and the traced counts beside them."""
    from repro_torch.parallel.analytic import step_cost

    ac = step_cost(cfg, shape, enc_S, dec_S).per_device(n_devices)
    return Roofline(
        flops_per_device=ac.flops,
        hbm_bytes_per_device=ac.hbm_bytes,
        collective_bytes_per_device=collectives.total_bytes,
        model_flops_global=model_flops(cfg, shape),
        n_devices=n_devices,
        collectives=collectives,
        hlo_flops_per_device=traced_flops_per_device,
        hlo_bytes_per_device=traced_bytes_per_device,
        kind=shape.kind,
        chip=H100.for_devices(n_devices),
    )
