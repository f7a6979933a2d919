"""Abstract parameter specs, their initialisation, and the logical ->
mesh sharding rules (PyTorch port of ``repro.models.param``).

A parameter is described by its shape, logical axis names and init rule, so
that the model's parameter tree can be listed without allocating; the
serving engine and the trainer materialise it with :func:`init_params`.

The rules map each logical axis to mesh axes of a
:class:`~repro_torch.launch.mesh.MeshLayout`: :func:`train_rules` (tensor
parallel over ``model``, FSDP over the data axes), :func:`fsdp_rules` (pure
FSDP/ZeRO-3 over every axis) and :func:`serve_rules`. A spec is a plain
tuple with one entry per dim: ``None``, an axis name, or a tuple of names;
it reads as JAX's ``tuple(PartitionSpec(...))``, one-name tuples collapsed
to the name as ``PartitionSpec`` collapses them. :func:`resolve_spec` keeps,
per dim, the longest prefix of the rule's axes whose sizes divide it, and
:func:`shard_shape` is one device's block of a tensor under a spec (JAX's
``NamedSharding.shard_shape``). The dry run (``launch.dryrun``) counts each
device's bytes from these; the port's steps still run on one card (a
sharded step is ROADMAP Queue 1 item 4c).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]  # one logical axis name (or None) per dim
    init: str = "normal"  # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 1.0  # stddev multiplier for normal init
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn, tree):
    """Apply ``fn`` to every :class:`ParamSpec` of a nested dict."""
    if is_spec(tree):
        return fn(tree)
    return {k: tree_map_specs(fn, v) for k, v in tree.items()}


def init_param(spec: ParamSpec, generator: torch.Generator) -> torch.Tensor:
    """One parameter on ``generator``'s device: zeros, ones, the Mamba2
    inits of ``A_log`` (``ssm_a``: log of U(1, 16)) and of the dt bias
    (``ssm_dt``: softplus^-1 of U(1e-3, 1e-1)), or a normal truncated at two
    standard deviations with fan-in scaling (stddev ``scale / sqrt(fan_in)``,
    fan-in the second-to-last dim), drawn in float32 and cast to the spec's
    dtype."""
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init in ("ssm_a", "ssm_dt"):
        lo, hi = (1.0, 16.0) if spec.init == "ssm_a" else (1e-3, 1e-1)
        u = torch.empty(spec.shape, dtype=torch.float32, device=dev)
        u.uniform_(lo, hi, generator=generator)
        return (torch.log(u) if spec.init == "ssm_a"
                else torch.log(torch.expm1(u))).to(spec.dtype)
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / math.sqrt(max(1, fan_in))
    x = torch.empty(spec.shape, dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return x.mul_(std).to(spec.dtype)  # in place: one float32 copy of the leaf


def init_params(tree, generator: torch.Generator) -> Any:
    """Materialise a ParamSpec tree, leaf after leaf in sorted key order
    from one generator (deterministic for a given seed and device)."""
    if is_spec(tree):
        return init_param(tree, generator)
    return {k: init_params(tree[k], generator) for k in sorted(tree)}


def abstract_params(tree) -> Any:
    """The tree as empty tensors of each leaf's shape and dtype on the
    ``meta`` device (allocates nothing)."""
    return tree_map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), tree)


# ---------------------------------------------------------------------------
# Logical -> physical sharding rules
# ---------------------------------------------------------------------------

Rules = Dict[str, Any]  # logical axis name -> mesh axis (str | tuple | None)
Spec = Tuple[Any, ...]  # one entry per dim: None, an axis name or a tuple of names


def train_rules(multi_pod: bool) -> Rules:
    fsdp = ("pod", "data") if multi_pod else ("data",)
    return {
        "embed": fsdp,  # FSDP: shard the d_model dim of weights
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "expert_slot": "model",  # MoE expert(+ffn-chunk) slots
        "expert_embed": fsdp,  # ZeRO-sharded expert d_model dim (gathered in situ)
        "expert_mlp": None,
        "layers": None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "state": None,
        "conv": None,
        "batch": fsdp,
        "seq": None,
        "act_embed": None,
        "act_heads": "model",
        "kv_seq": None,
        "moe_mode": "gather",
    }


def fsdp_rules(multi_pod: bool) -> Rules:
    """Pure FSDP/ZeRO-3: batch over every axis; params stored sharded on their
    d_model dim over all axes and all-gathered per layer."""
    allax = ("pod", "data", "model") if multi_pod else ("data", "model")
    return {
        "embed": allax,
        "heads": None,
        "kv_heads": None,
        "head_dim": None,
        "mlp": None,
        "vocab": None,
        "expert_slot": "model",
        "expert_embed": ("pod", "data") if multi_pod else ("data",),
        "expert_mlp": None,
        "moe_mode": "gather",
        "layers": None,
        "ssm_inner": None,
        "ssm_heads": None,
        "state": None,
        "conv": None,
        "batch": allax,
        "seq": None,
        "act_embed": None,
        "act_heads": None,
        "kv_seq": None,
    }


def serve_rules(multi_pod: bool, decode_seq_shard: bool = False) -> Rules:
    """Inference: weights TP over model, replicated over data; batch over data.
    Expert weights are ZeRO-sharded over the data axes and gathered in situ
    (prefill amortizes the gather over thousands of tokens); decode switches
    to token-routed EP (``launch.inputs.make_rules`` flips moe_mode/expert_*)."""
    dp = ("pod", "data") if multi_pod else ("data",)
    return {
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "expert_slot": "model",
        "expert_embed": dp,
        "expert_mlp": None,
        "moe_mode": "gather",
        "layers": None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "state": None,
        "conv": None,
        "batch": dp,
        "seq": None,
        "act_embed": None,
        "act_heads": "model",
        # flash-decoding style: shard the KV cache sequence over the model axis
        "kv_seq": "model" if decode_seq_shard else None,
    }


def _entry(axes):
    """One spec entry as ``PartitionSpec`` normalises it: no axes -> None,
    one axis -> its name, more -> a tuple of names."""
    if axes is None or isinstance(axes, str):
        return axes
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def pspec(*entries) -> Spec:
    """A spec of ``entries`` (``PartitionSpec(*entries)`` as a tuple)."""
    return tuple(_entry(e) for e in entries)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_to_spec(logical: Tuple[Optional[str], ...], rules: Rules) -> Spec:
    return pspec(*(rules.get(ax) if ax is not None else None for ax in logical))


def resolve_spec(shape: Tuple[int, ...], logical, rules: Rules, mesh) -> Spec:
    """Shape-aware spec: per dim, keep the longest prefix of the rule's mesh
    axes whose size product divides the dim (e.g. 8 KV heads on a 16-way model
    axis degrade to replication — the standard GQA fallback)."""
    entries = []
    for dim, ax in zip(shape, logical):
        keep, prod = [], 1
        for a in entry_axes(rules.get(ax) if ax is not None else None):
            if dim % (prod * mesh.shape[a]) == 0:
                keep.append(a)
                prod *= mesh.shape[a]
            else:
                break
        entries.append(keep)
    return pspec(*entries)


def param_pspecs(tree, rules: Rules, mesh=None):
    """Spec tree of a ParamSpec tree (shape-aware when ``mesh`` is given)."""
    if mesh is None:
        return tree_map_specs(lambda s: logical_to_spec(s.logical, rules), tree)
    return tree_map_specs(lambda s: resolve_spec(s.shape, s.logical, rules, mesh), tree)


def shard_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's block of a ``shape`` tensor laid out by ``spec`` over
    ``mesh`` (``NamedSharding.shard_shape``): each dim divided by the product
    of its entry's axis sizes. Raises, as JAX does, where that product does
    not divide the dim."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape} has dims")
    out = []
    for i, dim in enumerate(shape):
        n = math.prod(mesh.shape[a] for a in entry_axes(spec[i] if i < len(spec) else None))
        if dim % n:
            raise ValueError(f"spec {spec} splits dim {i} of {shape} {n} ways")
        out.append(dim // n)
    return tuple(out)


@dataclass(frozen=True, eq=False)
class Sharded:
    """An abstract tensor laid out over a mesh: an empty ``meta`` tensor of
    the global shape and dtype, and its spec (JAX's ``ShapeDtypeStruct``
    with a ``NamedSharding``)."""

    tensor: torch.Tensor
    spec: Spec
    mesh: Any

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.tensor.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype

    @property
    def shard_shape(self) -> Tuple[int, ...]:
        return shard_shape(self.shape, self.spec, self.mesh)

    @property
    def shard_bytes(self) -> int:
        """Bytes of one device's block."""
        return math.prod(self.shard_shape) * self.dtype.itemsize


def sharded(shape, dtype: torch.dtype, mesh, spec: Spec) -> Sharded:
    return Sharded(torch.empty(tuple(shape), dtype=dtype, device="meta"), tuple(spec), mesh)
