"""The dry run's derived collectives against the collectives XLA issues.

``launch.dryrun.derive_collectives`` counts, from the sharding rules, the
collectives a device runs in one step. Here each of the 30 smoke cells (the
10 assigned archs x train/prefill/decode, B 8, S 64) on the 8-device (2, 4)
Auto-axis mesh of the forced host devices is held against
``repro.parallel.roofline.parse_collectives`` over JAX's compiled step.

Two things of XLA:CPU are set aside first. It runs every collective in
float32 (a bfloat16 operand is converted before it), so both sides run
float32 configs. And the layers are unrolled, as in the reference's own
roofline compiles, so that each layer's collectives stand in the HLO once.

What is then compared, cell by cell:

* the kinds: every kind the port derives is one XLA issues, and XLA issues
  no other kind but those of :data:`XLA_ONLY`;
* the bytes a device sends, kind by kind and in all, within
  :data:`FACTOR`; a prefill's, which hold no gradient and no recompute,
  within :data:`PREFILL_TOL`.

Where XLA's choice differs from the port's accounting on purpose:

* XLA:CPU reduces a dense gradient with an all-reduce and keeps its slice,
  where the port (and the SPMD partitioner on a GPU or TPU) reduce-scatters
  it: an all-reduce sends twice a reduce-scatter's bytes. Where XLA issues
  no reduce-scatter (the dense train cells: every arch but the three MoE
  ones), the port's reduce-scatters are compared as those all-reduces.
* XLA keeps an expert weight it gathered in the forward for the backward
  (the recompute's all-gather of the same parameter is merged with the
  forward's), where the port gathers it again, as FSDP does when it frees
  a gathered weight after the forward: the MoE train cells' all-gather
  bytes come out near 2x XLA's (mixtral-8x7b 1.93).
* In the backward XLA all-reduces the input gradient of each column-split
  product on its own (q, k and v apart), where the port counts one
  all-reduce of their sum: the tensor-parallel train cells' all-reduce
  bytes come out at 0.61-0.84x XLA's, and their totals at 0.68-0.85x.
* ``XLA_ONLY``: in training the token embedding's lookup and its
  scatter-add exchange the looked-up rows of the d_model-split table
  (all-to-all), where the port counts the table's gather; and where the
  kv heads do not divide the model axis (every ``tp_fsdp`` arch) XLA
  re-lays the K/V projections' outputs (collective-permute). In decode XLA
  gathers the query to the cache's sequence split (all-gather), and
  reduces the split attention's output in two stages of two devices, not
  one ring of four (yi-34b decode: 0.56x in all).
"""

import jax
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import assigned_archs as jax_assigned_archs
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import inputs as jax_inputs
from repro.launch.mesh import set_mesh
from repro.launch.steps import abstract_state as jax_abstract_state
from repro.launch.steps import build_serve_step as jax_serve_step
from repro.models.config import ShapeConfig as JaxShapeConfig
from repro.parallel import roofline as jax_roofline
from repro_torch.configs import smoke_config
from repro_torch.launch import dryrun, mesh
from repro_torch.models.config import ShapeConfig

B, S = 8, 64
FACTOR = 2.0  # the port's bytes over XLA's, each way, kind by kind and in all
PREFILL_TOL = 0.05  # a prefill's, kind by kind
XLA_ONLY = {"train": {"all-to-all", "collective-permute"}, "prefill": set(),
            "decode": {"all-gather"}}

CELLS = [(arch, kind) for arch in jax_assigned_archs()
         for kind in ("train", "prefill", "decode")]


@pytest.fixture(scope="module")
def jax_mesh():
    return jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def xla_collectives(arch, kind, jax_mesh):
    jcfg = jax_smoke_config(arch).replace(dtype="float32", param_dtype="float32",
                                          unroll_layers=True)
    jshape = JaxShapeConfig(f"smoke_{kind}", S, B, kind)
    rules = jax_inputs.make_rules(jcfg, jshape, jax_mesh)
    step, opt = jax_serve_step(jcfg, jshape, jax_mesh, rules)
    state = jax_abstract_state(jcfg, jax_mesh, rules, opt)
    specs = jax_inputs.input_specs(jcfg, jshape, jax_mesh, rules)
    if kind == "train":
        args = (state, specs)
    elif kind == "prefill":
        args = (state["params"], specs)
    else:
        args = (state["params"], specs["token"], specs["pos"], specs["cache"])
    with set_mesh(jax_mesh):
        compiled = jax.jit(step).lower(*args).compile()
    return jax_roofline.parse_collectives(compiled.as_text())


@pytest.mark.parametrize("arch,kind", CELLS, ids=[f"{a}-{k}" for a, k in CELLS])
def test_derived_collectives_near_xla(arch, kind, jax_mesh):
    xla = xla_collectives(arch, kind, jax_mesh)
    cfg = smoke_config(arch).replace(dtype=torch.float32, param_dtype=torch.float32)
    shape = ShapeConfig(f"smoke_{kind}", S, B, kind)
    layout = mesh.make_local_mesh(2, 4)
    rules, _, _ = dryrun.lay_out(cfg, shape, layout)
    port = dryrun.derive_collectives(cfg, shape, layout, rules)

    ops, by = dict(port.ops), dict(port.bytes_by_kind)
    if "reduce-scatter" in ops and "reduce-scatter" not in xla.ops:
        ops["all-reduce"] = ops.get("all-reduce", 0) + ops.pop("reduce-scatter")
        by["all-reduce"] = by.get("all-reduce", 0.0) + 2 * by.pop("reduce-scatter")
    assert set(ops) <= set(xla.ops), (ops, xla.ops)
    assert set(xla.ops) - set(ops) <= XLA_ONLY[kind], (ops, xla.ops)
    ratios = {k: by[k] / xla.bytes_by_kind[k] for k in by}
    ratios["total"] = sum(by.values()) / xla.total_bytes
    lo, hi = ((1 - PREFILL_TOL, 1 + PREFILL_TOL) if kind == "prefill"
              else (1 / FACTOR, FACTOR))
    assert all(lo <= r <= hi for r in ratios.values()), ratios
