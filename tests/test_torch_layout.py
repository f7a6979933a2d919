"""The port's layout modules against JAX's, on abstract meshes.

``launch/mesh.py``, the rules and specs of ``models/param.py``,
``launch/inputs.py``'s ``make_rules`` and ``*_input_specs``,
``launch/steps.py::abstract_state`` over a mesh and the shape table of
``models/config.py``, held to the JAX package on ``AbstractMesh``es with
Auto axes (the reference's ``make_production_mesh`` builds Explicit axes,
which this jax rejects; ROADMAP "Open items"). Nothing here needs devices.

For all 10 assigned archs x 4 shapes x the two production layouts (16 x 16,
2 x 16 x 16): the shape table's verdict and reason, ``make_rules``, every
leaf's shape, dtype and spec (parameters, optimizer state, inputs, caches;
JAX's ``tuple(PartitionSpec)``) and the per-device argument bytes (the sum
of ``shard_shape`` times the item size) equal JAX's exactly.
"""

import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, NamedSharding, PartitionSpec

from repro.configs import assigned_archs as jax_assigned_archs
from repro.configs import get_config as jax_get_config
from repro.launch import inputs as jax_inputs
from repro.launch import mesh as jax_mesh
from repro.launch.steps import abstract_state as jax_abstract_state
from repro.models import config as jax_config
from repro.models import model as jax_model
from repro.models import param as jax_param
from repro.optim import Optimizer as JaxOptimizer
from repro_torch.configs import ALL, assigned_archs, get_config
from repro_torch.launch import dryrun, inputs, mesh, steps
from repro_torch.models import config, model, param

LAYOUTS = {"16x16": False, "2x16x16": True}


def jax_production_mesh(multi_pod):
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    return AbstractMesh(sizes, names, axis_types=(AxisType.Auto,) * len(sizes))


def port_leaves(tree, path=()):
    """(path, leaf) of a nested dict in JAX's order (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from port_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def jax_shard_bytes(x):
    return math.prod(x.sharding.shard_shape(x.shape)) * x.dtype.itemsize


def test_assigned_archs_and_shape_table_equal_jax():
    assert assigned_archs() == jax_assigned_archs()
    assert list(config.SHAPES_BY_NAME) == list(jax_config.SHAPES_BY_NAME)
    for name, s in config.SHAPES_BY_NAME.items():
        j = jax_config.SHAPES_BY_NAME[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)
    for arch in sorted(ALL):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        assert (cfg.attention_free, cfg.sub_quadratic) == (jcfg.attention_free,
                                                           jcfg.sub_quadratic), arch


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_mesh_layouts_equal_jax(multi_pod):
    pm = mesh.make_production_mesh(multi_pod=multi_pod)
    jm = jax_production_mesh(multi_pod)
    assert pm.axis_names == jm.axis_names
    assert pm.shape == dict(jm.shape)
    assert pm.size == jm.size
    assert pm.label == ("2x16x16" if multi_pod else "16x16")
    assert mesh.mesh_axis_sizes(pm) == dict(jm.shape)
    assert mesh.dp_axes(pm) == jax_mesh.dp_axes(jm)
    local = mesh.make_local_mesh(2, 4)
    assert (local.axis_names, local.axis_sizes, local.size) == (("data", "model"), (2, 4), 8)
    assert mesh.make_local_mesh(2, 2, pod=2).shape == {"pod": 2, "data": 2, "model": 2}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_rules_and_logical_specs_equal_jax(multi_pod):
    for port_fn, jax_fn in ((param.train_rules, jax_param.train_rules),
                            (param.fsdp_rules, jax_param.fsdp_rules)):
        assert port_fn(multi_pod) == jax_fn(multi_pod)
    for seq in (False, True):
        rules = param.serve_rules(multi_pod, seq)
        assert rules == jax_param.serve_rules(multi_pod, seq)
    cfg, jcfg = get_config("kimi-k2-1t-a32b"), jax_get_config("kimi-k2-1t-a32b")
    rules = param.train_rules(multi_pod)
    port = dict(port_leaves(param.param_pspecs(model.model_specs(cfg, 16), rules)))
    want = jax.tree.leaves(jax_param.param_pspecs(jax_model.model_specs(jcfg, 16), rules),
                           is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert [tuple(p) for p in want] == list(port.values())


def test_pspec_normalises_as_partition_spec():
    for entries in [(None,), ((),), (("data",), None), ("data", ("pod", "data")),
                    (["data", "model"],), ([],)]:
        assert param.pspec(*entries) == tuple(PartitionSpec(*entries)), entries


def test_shard_shape_equals_named_sharding_and_refuses_what_jax_refuses():
    jm = jax_production_mesh(True)
    pm = mesh.make_production_mesh(multi_pod=True)
    for shape, spec in [((64, 32), (("pod", "data"), "model")), ((8, 48, 16), (None, "model")),
                        ((), ()), ((4,), ("pod",))]:
        assert param.shard_shape(shape, spec, pm) == NamedSharding(
            jm, PartitionSpec(*spec)).shard_shape(shape)
    with pytest.raises(ValueError):
        NamedSharding(jm, PartitionSpec("model")).shard_shape((5,))
    with pytest.raises(ValueError):
        param.shard_shape((5,), ("model",), pm)


def test_default_state_is_the_one_device_tree():
    """With no mesh, ``abstract_state`` is meta tensors of the tree the
    port runs (every expert, ``slots = E``)."""
    cfg = get_config("mixtral-8x7b")
    st = steps.abstract_state(cfg, None)
    wg = st["params"]["decoder"]["b0"]["moe"]["wg"]
    assert isinstance(wg, torch.Tensor) and wg.device.type == "meta"
    assert wg.shape[1] == cfg.moe_num_experts
    laid = steps.abstract_state(cfg, None, mesh.make_production_mesh(), inputs.make_rules(
        cfg, config.SHAPES_BY_NAME["prefill_32k"], mesh.make_production_mesh()))
    # mixtral's 8 experts over a 16-way model axis: 2 FFN chunks an expert
    assert laid["params"]["decoder"]["b0"]["moe"]["wg"].shape[1] == 16


CELLS = [(arch, shape, layout) for layout in LAYOUTS for arch in jax_assigned_archs()
         for shape in jax_config.SHAPES_BY_NAME]


@pytest.mark.parametrize("arch,shape_name,layout", CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in CELLS])
def test_cell_layout_equals_jax(arch, shape_name, layout):
    multi_pod = LAYOUTS[layout]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shape, jshape = config.SHAPES_BY_NAME[shape_name], jax_config.SHAPES_BY_NAME[shape_name]
    ok = config.shape_applicable(cfg, shape)
    assert ok == jax_config.shape_applicable(jcfg, jshape)
    if not ok[0]:
        return
    pm, jm = mesh.make_production_mesh(multi_pod=multi_pod), jax_production_mesh(multi_pod)
    rules, state, port_inputs = dryrun.lay_out(cfg, shape, pm)
    jrules = jax_inputs.make_rules(jcfg, jshape, jm)
    assert rules == jrules
    opt = JaxOptimizer(jcfg.optimizer) if jshape.kind == "train" else None
    want = jax.tree.leaves((jax_abstract_state(jcfg, jm, jrules, opt),
                            jax_inputs.input_specs(jcfg, jshape, jm, jrules)))
    got = [leaf for _, leaf in port_leaves({"0": state, "1": port_inputs})]
    assert len(got) == len(want)
    for p, j in zip(got, want):
        assert p.shape == tuple(j.shape)
        assert str(p.dtype).removeprefix("torch.") == str(j.dtype)
        assert p.spec == tuple(j.sharding.spec), (p.shape, p.spec, j.sharding.spec)
        assert p.shard_bytes == jax_shard_bytes(j)
    assert dryrun.tree_bytes(state) + dryrun.tree_bytes(port_inputs) == sum(
        jax_shard_bytes(j) for j in want)
