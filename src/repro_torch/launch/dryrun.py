"""Multi-pod dry run: lay out and trace every (arch x shape x mesh) cell
(PyTorch port of ``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --out dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun ... --multi-pod   # 2x16x16 layout

The reference lowers and compiles each cell's step for a 512-device
placeholder mesh and reads XLA's memory and cost analyses and the HLO's
collectives. The port has no compiler to ask; it answers the same two
questions (does the step fit one device's memory, and what is its roofline)
from the layout and a data-less trace, on the CPU, allocating nothing:

1. **Layout.** ``make_rules`` over a :class:`~repro_torch.launch.mesh.
   MeshLayout`, then ``resolve_spec`` for every leaf of the parameters, the
   optimizer state (train), the inputs and the cache (decode).
   ``arg_bytes`` is the sum of each leaf's ``shard_shape`` times its item
   size (exact: equal to JAX's on the same layout). ``out_bytes`` comes the
   same way from the step's outputs: the new parameters and optimizer state
   and two float32 metrics (train); the logits (laid out as the reference's
   ``("batch", "seq", "vocab")``) and the cache (prefill, decode).
   ``alias_bytes`` is the cache for decode, which the port's decode step
   updates in place and returns, else 0: the train step returns a new tree
   and donates nothing.
2. **Trace.** Rank 0's step runs on ``meta`` tensors at full width, every
   layer, under a live-bytes count of every storage the step allocates and
   ``FlopCounterMode``. The attention kernels take their traceable ops
   (``kernels.traced``: outputs only, each kernel's own flop count); an MoE
   block's dispatch, which reads its group sizes on the card, splits the
   capacity evenly over its experts. Over a mesh of more than one device
   the step traced for the memory is the sharded step (``models.model.
   MeshCtx``) on rank 0's blocks of the weights, optimizer state, inputs
   and caches, in a fake world of the layout's size (:func:`trace_rank`:
   ``torch.distributed``'s ``fake`` backend, whose collectives give their
   results' shapes and exchange nothing): its gathers, casts, activations
   and gradients are the rank's own. ``temp_bytes`` is that trace's peak
   less its inputs and its new outputs. The FLOPs are the one-device step's
   on rank 0's share of the global batch (the batch over the batch axes
   ``make_rules`` keeps; ``slots = E``), spread evenly over the devices
   that share that batch (the model axis): ``hlo_flops_per_device`` beside
   the analytic ``flops_per_device``; ``hlo_bytes_per_device`` is the bytes
   every eager op of that trace reads and writes, spread the same way. The
   sharded trace's own FLOPs (``rank_traced_flops``) count rank 0's share
   of work the layout replicates over ``model`` (heads, KV heads or an SSM
   the model axis does not divide) once a rank.
3. **Collectives**, derived from the rules (:func:`derive_collectives`;
   :func:`count_collectives` counts those a real sharded step issues on a
   ``DeviceMesh``). Per step, a device runs:

   * an all-gather of every weight stored split over the mesh on its
     d_model dim (``embed``, ``expert_embed``: FSDP and the MoE ZeRO
     gather), its result the weight's block with those axes gathered, in
     the dtype the model uses it: once a forward, again in the backward
     (its recompute) when training;
   * (train) a reduce-scatter of each gradient over the batch axes the
     weight is split on, and an all-reduce over the batch axes it is not,
     in the parameter's dtype;
   * an all-reduce of the [B_local, S, D] activations after each
     row-split product: attention's and cross-attention's ``wo``, the MLP's
     and the shared expert's ``w_down``, the SSM's ``w_out``, when the
     model axis splits their contraction dim; in training once for the
     forward, once for the recompute (remat) and once for the backward's
     input gradient of the column-split products; and the SSM gate norm's
     [B_local, S] float32 sum of squares over the same split;
   * MoE: the combine's psum over the model axis ([T_local, D]), or, for
     token-routed decode, an all-gather of the tokens over the batch axes
     and a psum over the data x model axes ([T_global, D]);
   * an all-reduce of the embeddings after a vocab-split lookup; in
     training the loss's two [B_local, S] float32 reductions over a
     vocab-split unembedding and its input gradient's all-reduce;
   * (decode) an all-reduce of each attention's float32 partial output and
     row statistics over the axes that split the cache's sequence
     (flash-decoding).

   Each is costed with the ring formulas of ``parallel.roofline``, on the
   link of ``H100.for_devices(n)`` (NVLink within an 8-GPU node, the
   node's InfiniBand port beyond it).
4. **Roofline.** ``parallel.analytic.step_cost`` gives the FLOPs and HBM
   bytes a device (the kernels never write the scores), on the H100's
   constants; ``bytes_per_device = arg + temp + out - alias`` against the
   card's 80 GB gives ``fits_hbm``, True or False for every cell.

A model of more than three layer groups is traced at 2 and 3 groups and
each count extrapolated linearly to its depth (``compile_unrolled_s``), as
the reference extrapolates its cost analysis from 1 and 2 groups: from the
second group on, each group adds the same FLOPs and bytes (on the smoke
configs, 2 -> 3 -> 4 groups add equal amounts; the first group's peak
differs). The peak is the largest of a few points of the step, each growing
linearly with depth, and the extrapolation is exact while the point that
holds it at 2 and 3 groups holds it at full depth. Where a point that grows
faster takes over deeper down, the extrapolated peak is a lower bound: a
train step's model part does so on a 5-group smoke llama (9 % under), though
the step's peak there, the gradients plus the optimizer update's, is exact;
the card's two training steps agree to 1 % (``chip_smoke.py`` phase (l)). A
model of at most three groups is traced whole (``compile_s``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import assigned_archs, get_config
from repro_torch.launch.inputs import (batch_shards, cache_input_specs, input_specs,
                                      make_rules, split_seq)
from repro_torch.launch.mesh import MeshLayout, layout_of, make_local_mesh, make_production_mesh
from repro_torch.launch.steps import (abstract_state, build_serve_step, decoder_slots,
                                     loss_and_grads, model_param_specs, state_specs)
from repro_torch.models import model as model_mod
from repro_torch.models.config import (MAMBA, SHAPES_BY_NAME, ModelConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.models.param import entry_axes, resolve_spec, shard_shape, sharded
from repro_torch.obs.log import get_logger
from repro_torch.optim import Optimizer
from repro_torch.parallel.roofline import (CollectiveStats, build_roofline,
                                          extrapolate_collectives)

log = get_logger(__name__)

SRC = Path(__file__).resolve().parents[2]


def _leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

class LiveBytes(TorchDispatchMode):
    """Counts the storages the ops under it allocate: ``live`` bytes now,
    their ``peak``, and ``accessed``, the bytes every op reads and writes
    (views and ``empty`` excepted). A storage is new when an op returns it
    and none of the op's tensor arguments holds it; it leaves the count
    when it is freed (a finalizer on its Python object, which PyTorch keeps
    as long as the storage lives)."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.accessed = 0
        self.sizes = {}  # id of a counted storage -> its bytes

    def _free(self, key):
        self.live -= self.sizes.pop(key)

    def is_new(self, t: torch.Tensor) -> bool:
        return id(t.untyped_storage()) in self.sizes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in held or key in self.sizes:
                continue
            self.sizes[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)
        if not (func.is_view or func.__name__.startswith("empty")):
            self.accessed += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


@dataclasses.dataclass
class Trace:
    flops: float  # FlopCounterMode's total
    accessed: float  # bytes the eager ops read and write
    peak: int  # peak bytes of the storages the step allocated
    out_new: int  # bytes of the step's outputs it allocated
    end: int  # bytes it allocated that are still live when it returns
    batch: int  # sequences traced
    seconds: float
    extrapolated: bool = False
    args: int = 0  # bytes of the step's arguments the trace was given


def _trace(fn, batch: int, outputs=lambda res: res, args=()) -> Trace:
    """``fn()`` under :class:`LiveBytes` and ``FlopCounterMode``;
    ``outputs`` picks the step's outputs from its result, ``args`` are the
    trees of the step's arguments ``fn`` reads."""
    t0 = time.perf_counter()
    mem = LiveBytes()
    with FlopCounterMode(display=False) as flops, mem:
        res = fn()
    out_new = sum(t.untyped_storage().nbytes() for t in _unique_storages(outputs(res))
                  if mem.is_new(t))
    n_args = sum(t.untyped_storage().nbytes() for t in _unique_storages(args))
    return Trace(float(flops.get_total_flops()), float(mem.accessed), mem.peak, out_new,
                 mem.live, batch, time.perf_counter() - t0, args=n_args)


def _trace_model(cfg: ModelConfig, shape: ShapeConfig, batch: int) -> Trace:
    """The model's part of the step on ``batch`` sequences: the loss and
    its gradients (train, :func:`~repro_torch.launch.steps.loss_and_grads`),
    the prefill, or one decode step at the cache's last position (every
    slot attends), on ``meta`` tensors of the one-device parameters and the
    inputs (``launch.inputs``) at that batch."""
    local = dataclasses.replace(shape, global_batch=batch)
    one = make_local_mesh(1, 1)
    params = abstract_state(cfg, None)["params"]
    inputs = _tensors(input_specs(cfg, local, one, make_rules(cfg, local, one)))
    if shape.kind == "train":
        # the gradients are no output of the step: the update reads them
        return _trace(lambda: loss_and_grads(cfg, params, inputs), batch,
                      outputs=lambda r: r[0])
    step, _ = build_serve_step(cfg, local)
    if shape.kind == "prefill":
        run = lambda: step(params, inputs)  # noqa: E731
    else:
        pos = split_seq(cfg, shape.seq_len)[1] - 1
        run = lambda: step(params, inputs["token"], pos, inputs["cache"])  # noqa: E731
    with torch.no_grad():
        return _trace(run, batch)


def trace_step(cfg: ModelConfig, shape: ShapeConfig, batch: int) -> Trace:
    """Rank 0's step of ``shape``'s kind at full width on ``batch``
    sequences: the step the port runs (``launch.steps``) on ``meta``
    tensors. Its model part (:func:`_trace_model`) is traced whole up to
    three layer groups, else at 2 and 3 groups and extrapolated; a train
    step then adds ``opt.update`` (:func:`_with_update`)."""
    if cfg.num_groups <= 3:
        m = _trace_model(cfg, shape, batch)
    else:
        m = extrapolate_trace(_trace_model(grouped(cfg, 2), shape, batch),
                              _trace_model(grouped(cfg, 3), shape, batch), cfg.num_groups)
    return _with_update(cfg, shape, m)


def _with_update(cfg: ModelConfig, shape: ShapeConfig, m: Trace, mesh=None) -> Trace:
    """The step whose model part is ``m``: a train step's second part,
    ``opt.update`` on the one-device state (on rank 0's blocks of the
    ``DeviceMesh`` ``mesh``), is traced whole (its op count does not depend
    on depth), and the step's peak is the larger of the model part's and
    the gradients' bytes plus the update's."""
    if shape.kind != "train":
        return m
    opt = Optimizer(cfg.optimizer)
    if mesh is None:
        state = abstract_state(cfg, opt)
        grads = abstract_state(cfg, None)["params"]
        u = _trace(lambda: opt.update(grads, state["opt"], state["params"]), m.batch,
                   args=state["opt"])
    else:
        layout = layout_of(mesh)
        rules = make_rules(cfg, shape, layout)
        ctx = model_mod.MeshCtx(mesh, rules)
        specs = state_specs(cfg, layout, rules)["params"]
        state = _tensors(abstract_state(cfg, opt, layout, rules), local=True)
        grads = _tensors(abstract_state(cfg, None, layout, rules)["params"], local=True)
        u = _trace(lambda: opt.update(grads, state["opt"], state["params"], ctx=ctx,
                                      specs=specs), m.batch, args=state["opt"])
    return Trace(m.flops + u.flops, m.accessed + u.accessed, max(m.peak, m.end + u.peak),
                 m.out_new + u.out_new, m.end + u.end, m.batch, m.seconds + u.seconds,
                 m.extrapolated, m.args + u.args)


@contextlib.contextmanager
def rank_world(layout: MeshLayout):
    """A ``DeviceMesh`` of ``layout``'s axes over a fake process group of
    ``layout.size`` ranks, this process rank 0 (``torch.distributed``'s
    ``fake`` backend: every collective returns its result's shape and
    exchanges nothing; no CUDA, no NCCL). Torn down on exit. Raises where a
    process group is running: the trace then runs in a child process
    (:func:`trace_rank`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is running; trace rank 0 in a child process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=layout.size)
    try:
        yield init_device_mesh("cpu", layout.axis_sizes, mesh_dim_names=layout.axis_names)
    finally:
        dist.destroy_process_group()


def _trace_rank_model(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Trace:
    """:func:`_trace_model` of rank 0 of the ``DeviceMesh`` ``mesh``: the
    sharded step (``models.model.MeshCtx``) on ``meta`` tensors of rank 0's
    blocks of the parameters and inputs, as the rules lay them out."""
    layout = layout_of(mesh)
    rules = make_rules(cfg, shape, layout)
    ctx = model_mod.MeshCtx(mesh, rules)
    params = _tensors(abstract_state(cfg, None, layout, rules)["params"], local=True)
    specs = input_specs(cfg, shape, layout, rules)
    inputs = _tensors(specs, local=True)
    batch = shape.global_batch // batch_shards(layout, rules)
    if shape.kind == "train":
        return _trace(lambda: loss_and_grads(cfg, params, inputs, ctx), batch,
                      outputs=lambda r: r[0], args=(params, inputs))
    if shape.kind == "prefill":
        max_len = decoder_slots(cfg, shape.seq_len)
        run = lambda: model_mod.prefill_fn(cfg, params, inputs, max_len, ctx)  # noqa: E731
    else:
        pos = split_seq(cfg, shape.seq_len)[1] - 1
        slots = {b: e["k"].shape[2] for b, e in specs["cache"].items() if "k" in e}
        run = lambda: model_mod.decode_fn(cfg, params, inputs["token"], pos,  # noqa: E731
                                          inputs["cache"], ctx, slots)
    with torch.no_grad():
        return _trace(run, batch, args=(params, inputs))


def _trace_rank(cfg: ModelConfig, shape: ShapeConfig, layout: MeshLayout) -> Trace:
    with rank_world(layout) as mesh:
        if cfg.num_groups <= 3:
            m = _trace_rank_model(cfg, shape, mesh)
        else:
            m = extrapolate_trace(_trace_rank_model(grouped(cfg, 2), shape, mesh),
                                  _trace_rank_model(grouped(cfg, 3), shape, mesh),
                                  cfg.num_groups)
        return _with_update(cfg, shape, m, mesh)


def trace_rank(cfg: ModelConfig, shape: ShapeConfig, layout: MeshLayout) -> Trace:
    """Rank 0's step of ``shape``'s kind over ``layout`` at full width: the
    sharded step the port runs on a ``DeviceMesh`` of that layout, on
    ``meta`` tensors of rank 0's blocks, in a fake world of the layout's
    size (:func:`rank_world`), up to three layer groups whole, else at 2
    and 3 groups and extrapolated, a train step with its ``opt.update``.
    Where a process group is already running (a sharded run's), the trace
    runs in a child process, which starts its own."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return _trace_rank(cfg, shape, layout)
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        return pool.submit(_trace_rank, cfg, shape, layout).result()


def _tensors(tree, local: bool = False):
    """The meta tensors of a tree of :class:`Sharded` leaves; with
    ``local``, new ones of rank 0's blocks (each leaf's ``shard_shape``)."""
    if isinstance(tree, dict):
        return {k: _tensors(v, local) for k, v in tree.items()}
    if local:
        return torch.empty(tree.shard_shape, dtype=tree.dtype, device="meta")
    return tree.tensor


def _unique_storages(tree):
    seen, out = set(), []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor) and id(t.untyped_storage()) not in seen:
            seen.add(id(t.untyped_storage()))
            out.append(t)
    return out


def grouped(cfg: ModelConfig, k: int) -> ModelConfig:
    """``cfg`` cut to ``k`` layer groups (and ``k`` encoder layers)."""
    over = {"num_layers": k * len(cfg.pattern)}
    if cfg.is_encoder_decoder:
        assert cfg.num_encoder_layers == cfg.num_groups, cfg.name
        over["num_encoder_layers"] = k
    return cfg.replace(**over)


def extrapolate_trace(t2: Trace, t3: Trace, groups: int) -> Trace:
    """Each count of the 2- and 3-group traces taken linearly to
    ``groups``; the seconds are the two traces'."""
    def ex(a, b):
        return a + (groups - 2) * (b - a)
    return Trace(ex(t2.flops, t3.flops), ex(t2.accessed, t3.accessed),
                 int(ex(t2.peak, t3.peak)), int(ex(t2.out_new, t3.out_new)),
                 int(ex(t2.end, t3.end)), t2.batch, t2.seconds + t3.seconds, True,
                 int(ex(t2.args, t3.args)))


# ---------------------------------------------------------------------------
# the layout's bytes and collectives
# ---------------------------------------------------------------------------

def tree_bytes(tree) -> int:
    """One device's bytes of a tree of ``Sharded`` leaves."""
    return sum(leaf.shard_bytes for _, leaf in _leaves(tree))


def lay_out(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(rules, state, inputs) of a cell over ``mesh``: ``make_rules``, the
    step's state (``{"params"}``, and ``"opt"`` for train) and its inputs
    (the cache among them for decode), each leaf ``Sharded``."""
    rules = make_rules(cfg, shape, mesh)
    opt = Optimizer(cfg.optimizer) if shape.kind == "train" else None
    state = abstract_state(cfg, opt, mesh, rules)
    return rules, state, input_specs(cfg, shape, mesh, rules)


def output_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, rules, state, inputs) -> dict:
    """The step's outputs laid out over ``mesh``: the new state and the two
    float32 metrics (train); the float32 last-position logits and the cache
    (prefill, decode)."""
    if shape.kind == "train":
        scalar = sharded((), torch.float32, mesh, ())
        return {"state": state, "metrics": {"grad_norm": scalar, "loss": scalar}}
    B = shape.global_batch
    logits = sharded((B, 1, cfg.vocab_size), torch.float32, mesh,
                     resolve_spec((B, 1, cfg.vocab_size), ("batch", "seq", "vocab"), rules, mesh))
    cache = inputs["cache"] if shape.is_decode else cache_input_specs(cfg, shape, mesh, rules)
    return {"logits": logits, "cache": cache}


def _axes_n(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def derive_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh, rules) -> CollectiveStats:
    """The collectives a device runs in one step under ``rules`` over
    ``mesh``, as the module docstring sets out."""
    st = CollectiveStats()
    train = shape.kind == "train"
    act = cfg.activation_dtype.itemsize
    passes = (3 if cfg.remat_policy != "none" else 2) if train else 1
    enc_S, dec_S = split_seq(cfg, shape.seq_len)
    B_l = shape.global_batch // batch_shards(mesh, rules)
    S = 1 if shape.is_decode else dec_S
    D = cfg.d_model
    batch_axes = entry_axes(rules.get("batch"))
    pspecs = model_param_specs(cfg, mesh, rules)
    specs = {path: (s, resolve_spec(s.shape, s.logical, rules, mesh))
             for path, s in _leaves(pspecs)}

    # weights: FSDP / ZeRO gathers, gradient reductions
    for path, (s, spec) in specs.items():
        count = s.shape[0] if s.logical and s.logical[0] == "layers" else 1
        block = math.prod(shard_shape(s.shape, spec, mesh))
        gathered = [a for lg, e in zip(s.logical, spec) if lg in ("embed", "expert_embed")
                    for a in entry_axes(e)]
        if gathered:
            n = _axes_n(mesh, gathered)
            use = s.dtype if path[-1] in model_mod.SPEC_DTYPE_KEYS else cfg.activation_dtype
            for _ in range(2 if train else 1):
                st.add("all-gather", block * n * use.itemsize, n, count)
        if train:
            held = {a for e in spec for a in entry_axes(e)}
            rs = [a for a in batch_axes if a in held]
            ar = [a for a in batch_axes if a not in held]
            g = block * s.dtype.itemsize
            st.add("reduce-scatter", g, _axes_n(mesh, rs), count)
            st.add("all-reduce", g, _axes_n(mesh, ar), count)

    def split_axes(*path, dim=1):
        """Mesh axes splitting dim ``dim`` of a stacked weight."""
        hit = specs.get(path)
        return entry_axes(hit[1][dim]) if hit else ()

    def tp_all_reduce(axes, tokens, layers):
        st.add("all-reduce", tokens * D * act * layers * passes, _axes_n(mesh, axes),
               layers * passes)

    # activations: tensor-parallel all-reduces, MoE, decode's split cache
    G = cfg.num_groups
    n_model = mesh.shape["model"]
    for i, kind in enumerate(cfg.pattern):
        b = ("decoder", f"b{i}")
        if kind == MAMBA:
            axes = split_axes(*b, "ssm", "w_out", dim=1)
            tp_all_reduce(axes, B_l * S, G)
            # the gate norm's float32 sum of squares over the split channels
            st.add("all-reduce", B_l * S * 4 * G * passes, _axes_n(mesh, axes), G * passes)
        else:
            tp_all_reduce(split_axes(*b, "attn", "wo"), B_l * S, G)
            if cfg.is_encoder_decoder:
                tp_all_reduce(split_axes(*b, "cross", "wo"), B_l * S, G)
            kv_axes = ()
            if shape.is_decode:
                cache = model_mod.cache_specs(cfg, shape.global_batch, dec_S, enc_S)
                k = cache[f"b{i}"]["k"]
                kv_axes = entry_axes(resolve_spec(k.shape, k.logical, rules, mesh)[2])
            st.add("all-reduce", B_l * cfg.num_heads * (cfg.head_dim + 2) * 4 * G,
                   _axes_n(mesh, kv_axes), G)
        if (*b, "mlp", "w_down") in specs:
            tp_all_reduce(split_axes(*b, "mlp", "w_down"), B_l * S, G)
        if (*b, "shared_mlp", "w_down") in specs:
            tp_all_reduce(split_axes(*b, "shared_mlp", "w_down"), B_l * S, G)
        if (*b, "moe", "wg") in specs:
            if rules.get("moe_mode") == "token":
                T_g = shape.global_batch * S
                st.add("all-gather", T_g * D * act * G, _axes_n(mesh, batch_axes), G)
                st.add("all-reduce", T_g * D * act * G, mesh.shape["data"] * n_model, G)
            else:
                st.add("all-reduce", B_l * S * D * act * G * passes, n_model, G * passes)
    if cfg.is_encoder_decoder and not shape.is_decode:
        L = cfg.num_encoder_layers
        tp_all_reduce(split_axes("encoder", "attn", "wo"), B_l * enc_S, L)
        tp_all_reduce(split_axes("encoder", "mlp", "w_down"), B_l * enc_S, L)
    vocab_axes = entry_axes(specs[("embed",)][1][0])
    st.add("all-reduce", B_l * S * D * act, _axes_n(mesh, vocab_axes))
    if train:
        head = ("mlm_head",) if cfg.is_encoder_only else ("embed",) if cfg.tie_embeddings \
            else ("unembed",)
        dim = 0 if head == ("embed",) else 1
        n = _axes_n(mesh, entry_axes(specs[head][1][dim]))
        st.add("all-reduce", 2 * B_l * S * 4, n, 2)
        st.add("all-reduce", B_l * S * D * act, n)
    return st


def _count_step(cfg: ModelConfig, shape: ShapeConfig, mesh, seed: int) -> CollectiveStats:
    """One sharded step of the cell on ``mesh`` at the shape's size, from
    seeded weights and tokens, under ``CollectiveCounter``: this rank's
    collectives (decode: one step after the prefill's cache)."""
    from repro_torch.launch.steps import (build_decode_step, build_prefill_step,
                                          build_train_step, init_state)
    from repro_torch.models.param import distribute, pspec
    from repro_torch.parallel.collectives import CollectiveCounter

    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline

    layout = layout_of(mesh)
    dev = mesh.device_type
    B, S = shape.global_batch, shape.seq_len
    host = SyntheticTokenPipeline(cfg, DataConfig(B, S, seed)).batch_at(0)
    inputs = {k: v.to(dev) for k, v in host.items() if k != "targets" or shape.kind == "train"}
    tokens = inputs["tokens"]
    pos = tokens.shape[1] + (cfg.num_image_embeds if "image_embeds" in inputs else 0)

    def place(x, rules):
        return distribute(x, pspec(rules.get("batch"), *([None] * (x.dim() - 1))), mesh)

    if shape.kind == "train":
        opt = Optimizer(cfg.optimizer)
        rules = make_rules(cfg, shape, layout)
        batch = {k: place(v, rules) for k, v in inputs.items()}
        step = build_train_step(cfg, mesh, rules, opt)
        state = init_state(cfg, opt, dev, seed, mesh, rules)
        with CollectiveCounter() as counter:
            step(state, batch)
        return counter.stats
    prompt = ShapeConfig(shape.name, S, B, "prefill")
    decode = ShapeConfig(shape.name, S + 1, B, "decode")
    d_rules = make_rules(cfg, decode, layout)
    rules = {**make_rules(cfg, prompt, layout), "kv_seq": d_rules["kv_seq"]}
    params = init_state(cfg, None, dev, seed, mesh, rules)["params"]
    with torch.no_grad(), CollectiveCounter() as counter:
        _, cache = build_prefill_step(cfg, decode if shape.is_decode else prompt, mesh,
                                      rules)(params, {k: place(v, rules)
                                                      for k, v in inputs.items()})
    if not shape.is_decode:
        return counter.stats
    params = init_state(cfg, None, dev, seed, mesh, d_rules)["params"]
    with torch.no_grad(), CollectiveCounter() as counter:
        build_decode_step(cfg, mesh, d_rules)(params, place(tokens[:, -1:], d_rules), pos,
                                              cache)
    return counter.stats


def count_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh, seed: int = 0
                      ) -> CollectiveStats:
    """The collectives one sharded step of a cell issues on this rank of the
    ``DeviceMesh`` ``mesh``, counted by ``CommDebugMode``
    (``parallel.collectives.CollectiveCounter``) on a real step at the
    shape's size, with its bytes by the ring formulas; every rank of the
    mesh must call it. A model of more than two layer groups is counted at
    one and two groups and extrapolated to its depth
    (``extrapolate_collectives``), each group adding the same collectives.
    A decode shape counts one decode step after a prefill of ``seq_len``
    positions. The inputs are the seeded pipeline's (``data.pipeline``). It needs a running process group, so the dry run's CLI (which
    lays out meta tensors and starts none) does not call it: it serves the
    port's sharded tests, which hold these counts to XLA's collectives and
    to :func:`derive_collectives` on a (2, 4) gloo mesh."""
    if cfg.num_groups <= 2:
        return _count_step(cfg, shape, mesh, seed)
    return extrapolate_collectives(_count_step(grouped(cfg, 1), shape, mesh, seed),
                                   _count_step(grouped(cfg, 2), shape, mesh, seed),
                                   cfg.num_groups)


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             overrides: dict | None = None, *, mesh: MeshLayout | None = None,
             shape: ShapeConfig | None = None, cfg: ModelConfig | None = None) -> dict:
    """One cell's record (the reference's keys, plus the chip's constants,
    the trace's basis and the traced counts). ``mesh`` and ``shape`` replace
    the production layout and the named shape (the card's own 1 x 1 layout
    at a training step's size, say), ``cfg`` the registry's config of
    ``arch``; ``overrides`` replace config fields."""
    cfg = cfg or get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = shape or SHAPES_BY_NAME[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh.label}
    if overrides:
        rec["overrides"] = overrides
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec

    n_dev = mesh.size
    t0 = time.perf_counter()
    rules, state, inputs = lay_out(cfg, shape, mesh)
    arg_bytes = tree_bytes(state) + tree_bytes(inputs)
    out_bytes = tree_bytes(output_specs(cfg, shape, mesh, rules, state, inputs))
    alias_bytes = tree_bytes(inputs["cache"]) if shape.is_decode else 0
    collectives = derive_collectives(cfg, shape, mesh, rules)
    t_layout = time.perf_counter() - t0

    shards = batch_shards(mesh, rules)
    tr = trace_step(cfg, shape, shape.global_batch // shards)
    rank = trace_rank(cfg, shape, mesh) if n_dev > 1 else tr
    extrapolated = tr.extrapolated
    temp_bytes = max(0, rank.peak - rank.out_new)
    sharing = n_dev // shards  # devices that share rank 0's batch
    enc_S, dec_S = split_seq(cfg, shape.seq_len)
    roof = build_roofline(cfg, shape, n_dev, enc_S, dec_S, collectives,
                          traced_flops_per_device=tr.flops / sharing,
                          traced_bytes_per_device=tr.accessed / sharing)
    bytes_per_dev = arg_bytes + temp_bytes + out_bytes - alias_bytes
    rec.update(
        status="ok",
        lower_s=round(t_layout, 1),
        compile_s=0.0 if extrapolated else round(tr.seconds + (rank is not tr) * rank.seconds, 1),
        compile_unrolled_s=round(tr.seconds + (rank is not tr) * rank.seconds, 1)
        if extrapolated else 0.0,
        arg_bytes=arg_bytes,
        temp_bytes=temp_bytes,
        out_bytes=out_bytes,
        alias_bytes=alias_bytes,
        bytes_per_device=bytes_per_dev,
        fits_hbm=bytes_per_dev <= roof.chip.hbm_bytes,
        roofline=roof.to_dict(),
        chip=dataclasses.asdict(roof.chip),
        trace_batch=tr.batch,
        temp_basis=(
            f"traced peak of rank 0's step (full width, every layer, {tr.batch} of "
            f"{shape.global_batch} sequences"
            + (f", the sharded step on its blocks of the {mesh.label} layout's weights, "
               f"inputs and caches in a fake world of {n_dev} ranks" if n_dev > 1 else "")
            + ") less its inputs and new outputs"
            + ("; extrapolated from 2 and 3 groups" if extrapolated else "")),
        flops_basis=(f"FlopCounterMode over the one-device step on rank 0's batch (the "
                     f"one-device weights{', slots = E' if cfg.moe_num_experts else ''}), "
                     f"kernels by their own flop count, spread over the {sharing} devices "
                     f"sharing its batch"),
        traced_flops=tr.flops,
        traced_over_analytic=(tr.flops / sharing) / roof.flops_per_device
        if roof.flops_per_device else 0.0,
        rank_traced_flops=rank.flops,
        rank_arg_bytes=rank.args,
    )
    if verbose:
        log.info(f"[{rec['mesh']}] {arch} x {shape.name}: layout {t_layout:.1f}s trace "
                 f"{tr.seconds:.1f}s | {bytes_per_dev / 2**30:.2f} GiB/dev "
                 f"(fits={rec['fits_hbm']}) | bottleneck={roof.bottleneck} "
                 f"[C={roof.t_compute * 1e3:.2f}ms M={roof.t_memory * 1e3:.2f}ms "
                 f"X={roof.t_collective * 1e3:.2f}ms] mfu_bound={roof.mfu_bound:.3f}")
        log.info("  bytes: arg %d temp %d out %d alias %d", arg_bytes, temp_bytes, out_bytes,
                 alias_bytes)
        log.info("  analytic flops/device: %.3e bytes/device: %.3e | "
                 "traced flops/device: %.3e bytes/device: %.3e",
                 roof.flops_per_device, roof.hbm_bytes_per_device,
                 roof.hlo_flops_per_device, roof.hlo_bytes_per_device)
        log.info("  collectives: %s %s", collectives.ops,
                 {k: f"{v / 2**20:.1f}MiB" for k, v in collectives.bytes_by_kind.items()})
    return rec


def run_all(out_path: str, multi_pod: bool, archs=None, shapes=None) -> int:
    """Run every cell in a subprocess (isolation: one bad cell can't sink the
    fleet run) appending JSONL records."""
    archs = archs or assigned_archs()
    shapes = shapes or list(SHAPES_BY_NAME)
    failures = 0
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    for arch in archs:
        for shape_name in shapes:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name, "--out", out_path]
            if multi_pod:
                cmd.append("--multi-pod")
            try:
                rc = subprocess.run(cmd, env=env, timeout=1800).returncode
            except subprocess.TimeoutExpired:
                rc = -1
            if rc != 0:
                failures += 1
                with open(out_path, "a") as f:
                    f.write(json.dumps({"arch": arch, "shape": shape_name,
                                        "mesh": "2x16x16" if multi_pod else "16x16",
                                        "status": "error"}) + "\n")
    return failures


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (hillclimb experiments)")
    args = ap.parse_args()

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v

    if args.arch == "all":
        assert args.out, "--all requires --out"
        n_fail = run_all(args.out, args.multi_pod,
                         shapes=None if args.shape == "all" else [args.shape])
        sys.exit(1 if n_fail else 0)

    shapes = list(SHAPES_BY_NAME) if args.shape == "all" else [args.shape]
    for shape_name in shapes:
        try:
            rec = run_cell(args.arch, shape_name, args.multi_pod,
                           overrides=overrides or None)
        except Exception:
            traceback.print_exc()
            sys.exit(1)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
