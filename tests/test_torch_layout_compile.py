"""The dry run's argument bytes against JAX's compiled steps.

On the 8-device (2, 4) Auto-axis mesh of the forced host devices, for the
smoke configs of the 10 assigned archs x train/prefill/decode (B 8, S 64):
the port's per-device argument bytes (``launch.dryrun.lay_out``, the sum
of ``shard_shape`` times the item size) equal the sum JAX's
``NamedSharding.shard_shape`` gives over the lowered step's arguments,
exactly, in all 30 cells. They also equal XLA's
``compile().memory_analysis().argument_size_in_bytes``, except where XLA
prunes an argument the step never reads: whisper-base's decode step reads
neither the encoder's weights, ``enc_norm`` nor the cross-attention's
``wk``/``wv`` (its cross K/V come from the cache; 83 200 bytes), and
mamba2-370m's decode reads no ``pos`` (4 bytes).
"""

import math

import jax
import pytest
from jax.sharding import AxisType

from repro.configs import assigned_archs as jax_assigned_archs
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import inputs as jax_inputs
from repro.launch.mesh import set_mesh
from repro.launch.steps import abstract_state as jax_abstract_state
from repro.launch.steps import build_serve_step as jax_serve_step
from repro.models.config import ShapeConfig as JaxShapeConfig
from repro_torch.configs import smoke_config
from repro_torch.launch import dryrun, mesh
from repro_torch.models.config import ShapeConfig

B, S = 8, 64
# (arch, kind) -> (JAX's shard sum, XLA's argument bytes): the two cells
# where XLA prunes arguments the step never reads
PRUNED = {("whisper-base", "decode"): (478_228, 395_028),
          ("mamba2-370m", "decode"): (105_540, 105_536)}

CELLS = [(arch, kind) for arch in jax_assigned_archs()
         for kind in ("train", "prefill", "decode")]


@pytest.fixture(scope="module")
def jax_mesh():
    return jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


@pytest.mark.parametrize("arch,kind", CELLS, ids=[f"{a}-{k}" for a, k in CELLS])
def test_smoke_arg_bytes_equal_jax_compile(arch, kind, jax_mesh):
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
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
    shard_sum = sum(math.prod(x.sharding.shard_shape(x.shape)) * x.dtype.itemsize
                    for x in jax.tree.leaves(args))
    xla = compiled.memory_analysis().argument_size_in_bytes

    prules, pstate, pinputs = dryrun.lay_out(cfg, ShapeConfig(f"smoke_{kind}", S, B, kind),
                                             mesh.make_local_mesh(2, 4))
    assert prules == rules
    port = dryrun.tree_bytes(pstate) + dryrun.tree_bytes(pinputs)
    assert port == shard_sum
    if (arch, kind) in PRUNED:
        assert (shard_sum, xla) == PRUNED[(arch, kind)]
    else:
        assert port == xla
