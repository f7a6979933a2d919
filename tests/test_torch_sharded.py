"""The sharded train and serve steps over a ``torch.distributed``
``DeviceMesh``, held against JAX's jitted steps on the same mesh.

One spawn of 8 gloo ranks on the CPU (``tests/_torch_sharded_worker.py``,
no JAX in them) runs every cell on a (2, 4) ``("data", "model")`` mesh,
while this process compiles and runs JAX's step of the same cell on the
Auto-axis (2, 4) mesh of the forced host devices (built as
``tests/test_torch_collectives.py`` builds it, not through ``mesh1``). Smoke
configs in float32, B 8, S 64, the same parameters (``shared_params``) and
inputs on both sides.

* **Train cells** (llama3.2-1b on the FSDP rules; roberta-large, yi-34b and
  kimi-k2 on tensor parallelism + FSDP; kimi-k2 with float32 storage): the
  loss, every gradient, every updated parameter and the optimizer state,
  each leaf within 1e-4 of JAX's (gap norm over norm), assembled from the
  ranks' blocks (ranks that hold the same block must hold the same bits).
* **Serve cells** (llama3.2-1b, qwen3-8b, kimi-k2): the prefill's logits
  and cache and 4 decode steps' logits within 2e-5. The prefill runs the
  serve rules (kimi-k2's MoE in gather mode), decode the decode rules: the
  cache split by sequence over ``model`` and merged by log-sum-exp, and
  kimi-k2's experts token-routed over the whole mesh. Every cell has 4
  query heads and 2 KV heads over a model axis of 4 (yi-34b 16 and 2), so
  the KV heads are replicated (the GQA fallback) and each rank slices the
  KV head its query heads read. kimi-k2 runs at a capacity factor of 1.0
  on both sides, so that the per-shard capacity cuts rows (asserted): at
  1.25 no shard of these inputs is full.
* **Layout**: every rank's blocks have ``shard_shape(resolve_spec(...))``
  and the placements of ``resolve_spec``.
* **Collectives**: ``launch.dryrun.count_collectives`` (``CommDebugMode``
  and the bytes) of each cell's sharded step against ``parse_collectives`` of the same
  compiled JAX step (layers unrolled), by ``test_torch_collectives.py``'s
  rules (``FACTOR``, ``PREFILL_TOL``, ``XLA_ONLY``, a reduce-scatter XLA:CPU
  runs as an all-reduce), and against ``dryrun.derive_collectives`` by the
  same rules. The counted and derived numbers agree for every prefill
  cell (llama3.2-1b, qwen3-8b, kimi-k2: the same ops and bytes). They
  differ in these cells:

  - the train cells: all-gather bytes 0.91 (llama3.2-1b), 0.83
    (roberta-large), 0.89 (yi-34b), 0.92 (kimi-k2) of the derived, one or
    two ops fewer: the port gathers the weights outside the layer stack
    (embeddings, unembedding, final norm) once, where the derivation
    gathers every weight again for its recompute. All-reduce bytes 1.01,
    0.86, 0.87, 0.92: the port's vocab-split loss takes three [B_l, S]
    all-reduces (max, sum of exponentials, gold logit) where the
    derivation counts two, and it all-reduces the gradient of each leaf
    replicated over ``model`` (norm scales, the router, GQA-replicated KV
    weights) where the derivation counts the batch axes only; the
    tensor-parallel backward all-reduces where the forward did (an
    all-reduce's adjoint), so no separate all-reduce of the unembedding's
    input gradient. kimi-k2 counts 69 all-reduce ops against 29: its
    Adafactor takes the row and column means and the update's RMS of each
    leaf split over a reduced dim by an all-reduce of a few floats (about
    40 ops of tens of bytes), which the derivation does not count.
  - the decode cells (llama3.2-1b, qwen3-8b, kimi-k2): the same all-reduce
    bytes (the split cache's merge as a max and a sum all-reduce of the
    derivation's row statistics and partial outputs), plus an all-gather
    of the query over the heads before the sequence-split cache, one a
    layer, which XLA issues too and the derivation does not count (total
    1.14, 1.14, 1.08).

* **Checkpoint**: a sharded state saved whole restores bit for bit onto the
  (2, 4) mesh and onto a (1, 1) mesh through ``elastic_reshard``.
* **Launchers**: ``launch.train`` and ``launch.serve`` with ``--data-par 2
  --model-par 4 --device cpu`` train and serve on the 8 ranks; an arch
  outside the slice raises ``NotImplementedError`` naming item 4d.
  kimi-k2's ``ServeEngine`` holds one copy of its weights and reshards the
  expert weights between the prefill and decode layouts.
* **A 1 x 1 mesh** (one gloo rank, this process): the sharded train step
  equals the plain step bit for bit, and the sharded engine's tokens equal
  the plain engine's, every decode through ``decode_attention_lse``.
"""

import math
import os
import pickle
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

from conftest import make_batch
from _torch_train_ref import shared_params
from test_torch_collectives import FACTOR, PREFILL_TOL, XLA_ONLY
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import inputs as jax_inputs
from repro.launch.mesh import set_mesh
from repro.launch.steps import abstract_state as jax_abstract_state
from repro.launch.steps import build_serve_step as jax_serve_step
from repro.models import model as jax_model
from repro.models.config import ShapeConfig as JaxShapeConfig
from repro.models.param import init_params as jax_init_params
from repro.parallel import roofline as jax_roofline
from repro_torch.configs import smoke_config
from repro_torch.kernels import decode_attention as dec_kernel
from repro_torch.launch import dryrun
from repro_torch.launch.inputs import make_rules
from repro_torch.launch.mesh import MeshLayout, make_device_mesh
from repro_torch.launch.serve import ServeEngine
from repro_torch.launch.steps import abstract_state, build_train_step, init_state, state_specs
from repro_torch.models.config import ShapeConfig
from repro_torch.models.param import shard_shape, shard_slices
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.parallel.roofline import CollectiveStats
from repro_torch.runtime.fault_tolerance import elastic_reshard

B, S, N_DECODE = 8, 64, 4
TRAIN_RTOL, SERVE_RTOL = 1e-4, 2e-5
TRAIN = ["llama3.2-1b", "roberta-large", "yi-34b", "kimi-k2-1t-a32b"]
SERVE = ["llama3.2-1b", "qwen3-8b", "kimi-k2-1t-a32b"]
LAYOUT = MeshLayout(("data", "model"), (2, 4))
WORKER = Path(__file__).with_name("_torch_sharded_worker.py")
SPAWN_TIMEOUT = 600


def overrides(arch):
    over = {"dtype": "float32", "param_dtype": "float32"}
    if arch == "kimi-k2-1t-a32b":
        over["moe_capacity_factor"] = 1.0
    return over


def jax_config(arch):
    return jax_smoke_config(arch).replace(unroll_layers=True, **overrides(arch))


def port_config(arch):
    over = {k: getattr(torch, v) if "dtype" in k else v for k, v in overrides(arch).items()}
    return smoke_config(arch).replace(**over)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _placed(tree, abstract):
    return jax.tree.map(lambda x, a: jax.device_put(jnp.asarray(x), a.sharding), tree, abstract)


def jax_train(arch, jm, params):
    jcfg = jax_config(arch)
    shape = JaxShapeConfig("t", S, B, "train")
    rules = jax_inputs.make_rules(jcfg, shape, jm)
    step, opt = jax_serve_step(jcfg, shape, jm, rules)
    abstract = jax_abstract_state(jcfg, jm, rules, opt)
    zeros = jax_init_params(opt.init_specs(jax_model.model_specs(jcfg, 1)), jax.random.key(1))
    state = _placed({"params": params, "opt": zeros}, abstract)
    batch = make_batch(jcfg, B, S)
    batch = _placed(batch, jax_inputs.input_specs(jcfg, shape, jm, rules))
    ctx = jax_model.MeshCtx(jm, rules)
    with set_mesh(jm):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jax_model.loss_fn(jcfg, p, batch, ctx)))(state["params"])
        compiled = jax.jit(step).lower(state, batch).compile()
        new, metrics = compiled(state, batch)
    return {"loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
            "new": jax.tree.map(np.asarray, new), "placed_params": state["params"],
            "metrics": {k: float(v) for k, v in metrics.items()},
            "xla": jax_roofline.parse_collectives(compiled.as_text())}


def jax_serve(arch, jm, params, prompt, tokens):
    jcfg = jax_config(arch)
    out = {}
    shape = JaxShapeConfig("t", S + N_DECODE, B, "prefill")
    rules = jax_inputs.make_rules(jcfg, shape, jm)
    prefill, _ = jax_serve_step(jcfg, shape, jm, rules)
    p = _placed(params, jax_abstract_state(jcfg, jm, rules, None)["params"])
    batch = {"tokens": jax.device_put(jnp.asarray(prompt, jnp.int32),
                                      NamedSharding(jm, P(rules.get("batch"), None)))}
    with set_mesh(jm):
        compiled = jax.jit(prefill).lower(p, batch).compile()
        logits, cache = compiled(p, batch)
    out["prefill_logits"] = np.asarray(logits)
    out["cache"] = jax.tree.map(np.asarray, cache)
    out["xla_prefill"] = jax_roofline.parse_collectives(compiled.as_text())
    shape = JaxShapeConfig("t", S + N_DECODE, B, "decode")
    rules = jax_inputs.make_rules(jcfg, shape, jm)
    decode, _ = jax_serve_step(jcfg, shape, jm, rules)
    p = _placed(params, jax_abstract_state(jcfg, jm, rules, None)["params"])
    specs = jax_inputs.input_specs(jcfg, shape, jm, rules)
    cache = _placed(out["cache"], specs["cache"])
    logits_all = []
    with set_mesh(jm):
        tok = jax.device_put(jnp.asarray(tokens[0], jnp.int32), specs["token"].sharding)
        compiled = jax.jit(decode).lower(p, tok, jnp.int32(S), cache).compile()
        for i in range(N_DECODE):
            tok = jax.device_put(jnp.asarray(tokens[i], jnp.int32), specs["token"].sharding)
            logits, cache = compiled(p, tok, jnp.int32(S + i), cache)
            logits_all.append(np.asarray(logits))
    out["decode_logits"] = logits_all
    out["xla_decode"] = jax_roofline.parse_collectives(compiled.as_text())
    return out


def assemble(blocks):
    """The whole array from every rank's (block, spec), checking that ranks
    holding the same block hold the same bits."""
    (first, spec), coords0 = blocks[0]
    shape = tuple(n * math.prod(LAYOUT.shape[a] for a in ([e] if isinstance(e, str) else e or ()))
                  for n, e in zip(first.shape, tuple(spec) + (None,) * (first.ndim - len(spec))))
    out, seen = np.zeros(shape, np.float32), {}
    for (blk, sp), coords in blocks:
        assert tuple(sp) == tuple(spec)
        sl = shard_slices(shape, spec, LAYOUT, coords)
        key = tuple((s.start, s.stop) for s in sl)
        if key in seen:
            assert np.array_equal(seen[key], blk), "ranks hold different bits of one block"
        seen[key] = blk
        out[sl] = blk
    return out


def _blocks(ranks, get):
    return [(get(r), r["coords"]) for r in ranks]


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the 8 ranks, compute JAX's cells meanwhile, and return both."""
    tmp = tmp_path_factory.mktemp("sharded")
    jm = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rng = np.random.default_rng(0)
    params = {arch: shared_params(jax_config(arch)) for arch in set(TRAIN) | set(SERVE)}
    batches = {arch: {k: np.asarray(v) for k, v in make_batch(jax_config(arch), B, S).items()}
               for arch in TRAIN}
    prompts = {arch: rng.integers(0, jax_config(arch).vocab_size, (B, S)).astype(np.int32)
               for arch in SERVE}
    tokens = {arch: rng.integers(0, jax_config(arch).vocab_size,
                                 (N_DECODE, B, 1)).astype(np.int32) for arch in SERVE}
    tasks = {"B": B, "S": S, "checkpoint_arch": "llama3.2-1b",
             "ckpt_dir": str(tmp / "ckpt"),
             "launch_dirs": {"train": str(tmp / "launch_ckpt")},
             "engine_arch": "kimi-k2-1t-a32b", "engine_over": overrides("kimi-k2-1t-a32b"),
             "train": [{"arch": a, "over": overrides(a), "params": params[a],
                        "batch": batches[a]} for a in TRAIN],
             "serve": [{"arch": a, "over": overrides(a), "params": params[a],
                        "prompt": prompts[a], "tokens": tokens[a]} for a in SERVE]}
    with open(tmp / "tasks.pkl", "wb") as f:
        pickle.dump(tasks, f)
    env = dict(os.environ, WORLD_SIZE="8", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(Path(__file__).parents[1] / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(tmp / "tasks.pkl"), str(tmp)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
             for r in range(8)]
    try:
        with ThreadPoolExecutor(4) as pool:  # XLA compiles without the GIL
            train = {a: pool.submit(jax_train, a, jm, params[a]) for a in TRAIN}
            serve = {a: pool.submit(jax_serve, a, jm, params[a], prompts[a], tokens[a])
                     for a in SERVE}
            ref = {"train": {a: f.result() for a, f in train.items()},
                   "serve": {a: f.result() for a, f in serve.items()}}
        errs = [p.communicate(timeout=SPAWN_TIMEOUT)[1].decode()[-3000:] for p in procs]
    finally:
        for p in procs:
            p.kill()
    ranks = []
    for r in range(8):
        path = tmp / f"rank{r}.pkl"
        assert path.exists(), f"rank {r} wrote nothing:\n{errs[r]}"
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))
        assert "error" not in ranks[r], ranks[r]["error"]
    return {"ranks": ranks, "ref": ref, "params": params, "tmp": tmp, "jax_mesh": jm}


@pytest.mark.parametrize("arch", TRAIN)
def test_train_step_matches_jax_on_a_2x4_mesh(run, arch):
    ranks, ref = run["ranks"], run["ref"]["train"][arch]
    got = [r["train"][arch] for r in ranks]
    assert all(g["loss"] == got[0]["loss"] for g in got)
    assert abs(got[0]["grad_loss"] - ref["loss"]) <= TRAIN_RTOL * abs(ref["loss"])
    assert abs(got[0]["loss"] - ref["metrics"]["loss"]) <= TRAIN_RTOL * ref["metrics"]["loss"]
    assert abs(got[0]["grad_norm"] - ref["metrics"]["grad_norm"]) <= (
        TRAIN_RTOL * ref["metrics"]["grad_norm"])
    want = {"grads": flat(ref["grads"]), "params": flat(ref["new"]["params"]),
            "opt": flat(ref["new"]["opt"])}
    gaps = {}
    for part in ("grads", "params", "opt"):
        for path in want[part]:
            whole = assemble(_blocks(ranks, lambda r: r["train"][arch][part][path]))
            gaps[f"{part}/{path}"] = rel(whole, want[part][path])
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= TRAIN_RTOL, (worst, gaps[worst])


@pytest.mark.parametrize("arch", SERVE)
def test_serve_steps_match_jax_on_a_2x4_mesh(run, arch):
    ranks, ref = run["ranks"], run["ref"]["serve"][arch]
    got = lambda key: assemble(_blocks(ranks, lambda r: r["serve"][arch][key]))  # noqa: E731
    assert rel(got("prefill_logits"), ref["prefill_logits"]) <= SERVE_RTOL
    for path, want in flat(ref["cache"]).items():
        whole = assemble(_blocks(ranks, lambda r: r["serve"][arch]["cache"][path]))
        assert rel(whole, want) <= SERVE_RTOL, path
    for i in range(N_DECODE):
        whole = assemble(_blocks(ranks, lambda r: r["serve"][arch]["decode_logits"][i]))
        assert rel(whole, ref["decode_logits"][i]) <= SERVE_RTOL, f"decode step {i}"


def test_moe_per_shard_capacity_drops_rows(run):
    """kimi-k2's sharded steps cut rows at the per-shard capacity in both
    MoE modes' cells (the unsharded port never does: one device's capacity
    holds every row); the cells above match JAX with those rows dropped."""
    ranks = run["ranks"]
    assert sum(r["train"]["kimi-k2-1t-a32b"]["dropped"] for r in ranks) > 0
    assert sum(r["serve"]["kimi-k2-1t-a32b"]["prefill_dropped"] for r in ranks) > 0


def test_local_blocks_have_the_layouts_shard_shapes(run):
    for arch in TRAIN:
        cfg = port_config(arch)
        opt = make_optimizer(cfg.optimizer)
        rules = make_rules(cfg, ShapeConfig("t", S, B, "train"), LAYOUT)
        specs = state_specs(cfg, LAYOUT, rules, opt)
        shapes = {k: flat(abstract_state(cfg, opt, LAYOUT, rules)[k]) for k in specs}
        for part in ("params", "opt"):
            for path, spec in flat(specs[part]).items():
                want = shard_shape(shapes[part][path].shape, spec, LAYOUT)
                for r in run["ranks"]:
                    blk, got_spec = r["train"][arch][part][path]
                    assert tuple(got_spec) == tuple(spec), (arch, path)
                    assert blk.shape == want, (arch, path)


def _bounds(index, shape):
    return tuple((sl.start or 0, n if sl.stop is None else sl.stop)
                 for sl, n in zip(index, shape))


def test_rank_blocks_are_jax_addressable_shards(run):
    """Rank ``d * 4 + m`` holds the block that JAX's device at mesh position
    (d, m) holds of each parameter laid out by the same rules (the
    data-outer order of a dim split over both axes included), and its
    updated block is that block of JAX's updated parameter."""
    where = {dev.id: (d, m) for (d, m), dev in np.ndenumerate(run["jax_mesh"].devices)}
    for arch in TRAIN:
        ref = run["ref"]["train"][arch]
        new = flat(ref["new"]["params"])
        for path, arr in flat(ref["placed_params"]).items():
            for shard in arr.addressable_shards:
                d, m = where[shard.device.id]
                blk, spec = run["ranks"][d * 4 + m]["train"][arch]["params"][path]
                mine = shard_slices(arr.shape, spec, LAYOUT, {"data": d, "model": m})
                assert _bounds(mine, arr.shape) == _bounds(shard.index, arr.shape), (arch, path)
                assert rel(blk, new[path][mine]) <= TRAIN_RTOL, (arch, path)


def _held(stats, xla, kind):
    """test_torch_collectives.py's bounds of counted stats against XLA's."""
    ops, by = dict(stats["ops"]), dict(stats["bytes"])
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
    return ratios


COLLECTIVE_CELLS = ([(a, "train") for a in TRAIN] + [(a, "prefill") for a in SERVE]
                    + [(a, "decode") for a in SERVE])


@pytest.mark.parametrize("arch,kind", COLLECTIVE_CELLS,
                         ids=[f"{a}-{k}" for a, k in COLLECTIVE_CELLS])
def test_counted_collectives_near_xla_and_derived(run, arch, kind):
    r0 = run["ranks"][0]
    if kind == "train":
        stats, xla = r0["train"][arch]["collectives"], run["ref"]["train"][arch]["xla"]
        shape = ShapeConfig("t", S, B, "train")
    else:
        stats = r0["serve"][arch][f"{kind}_collectives"]
        xla = run["ref"]["serve"][arch][f"xla_{kind}"]
        # the prefill's S prompt tokens; decode's cache of the S + 4 positions
        shape = ShapeConfig("t", S if kind == "prefill" else S + N_DECODE, B, kind)
    assert all(r == stats for r in [x["train"][arch]["collectives"] if kind == "train"
                                    else x["serve"][arch][f"{kind}_collectives"]
                                    for x in run["ranks"]])
    assert stats["ops"], "CommDebugMode counted no collective"
    _held(stats, xla, kind)
    cfg = port_config(arch)
    rules = make_rules(cfg, shape, LAYOUT)
    derived = dryrun.derive_collectives(cfg, shape, LAYOUT, rules)
    as_xla = CollectiveStats(dict(derived.ops), dict(derived.bytes_by_kind), derived.total_bytes)
    if kind == "decode":  # the query gather the derivation does not count
        as_xla.ops["all-gather"] = as_xla.ops.get("all-gather", 0) + 1
        as_xla.bytes_by_kind.setdefault("all-gather", stats["bytes"].get("all-gather", 0.0))
        as_xla.total_bytes = sum(as_xla.bytes_by_kind.values())
    _held(stats, as_xla, kind)


def test_sharded_checkpoint_restores_bit_for_bit_on_2x4(run):
    assert all(r["checkpoint"]["bit_identical"] for r in run["ranks"])


def test_launchers_train_and_serve_on_8_ranks(run):
    for r in run["ranks"]:
        out = r["launchers"]
        assert len(out["train_losses"]) == 3 and np.isfinite(out["train_losses"]).all()
        assert out["serve"]
        for arch in ("mamba2-370m", "gemma2-9b", "whisper-base"):
            assert "ROADMAP Queue 1 item 4d" in out[arch], (arch, out[arch])


def test_sharded_engine_holds_one_copy_of_the_weights(run):
    """kimi-k2's engine on the (2, 4) mesh: one parameter tree, its MoE
    expert weights ([layers, slots, ...]) resharded from the prefill layout (slots over ``model``,
    d_model over ``data``) to the decode layout (slots over both) and back,
    no other leaf moved; the same tokens on every rank and every generate."""
    for r in run["ranks"]:
        out = r["engine"]
        assert out["phase"] == "decode"
        assert out["moved"] and all(p.rsplit("/", 1)[-1] in ("wg", "wu", "wd_")
                                    for p in out["moved"]), out["moved"]
        assert all(out["decode_specs"][p][1] == ("data", "model") for p in out["moved"])
        assert out["round_trip"]
        assert np.array_equal(out["tokens"][0], out["tokens"][1])
        assert np.array_equal(out["tokens"][0], run["ranks"][0]["engine"]["tokens"][0])


@pytest.fixture(scope="module")
def one_rank_mesh(run):
    """A (1, 1) gloo mesh in this process (after the spawn is done)."""
    mesh = make_device_mesh(1, 1, "cpu")
    yield mesh
    torch.distributed.destroy_process_group()


def test_sharded_checkpoint_restores_bit_for_bit_on_1x1(run, one_rank_mesh):
    cfg = port_config("llama3.2-1b")
    opt = make_optimizer(cfg.optimizer)
    with np.load(run["ranks"][0]["checkpoint"]["path"]) as data:
        host = {}
        for k in data.files:
            if k != "__step__":
                *head, last = k.split("/")
                node = host
                for h in head:
                    node = node.setdefault(h, {})
                node[last] = data[k]
    rules = make_rules(cfg, ShapeConfig("t", S, B, "train"), MeshLayout(("data", "model"), (1, 1)))
    back = elastic_reshard(lambda m: abstract_state(cfg, opt, m, rules), host, one_rank_mesh)
    saved = run["ranks"][0]["checkpoint"]["state"]
    for part in ("params", "opt"):
        for path, x in flat(back[part]).items():
            whole = assemble(_blocks(run["ranks"], lambda r: r["checkpoint"]["state"][part][path]))
            assert np.array_equal(x.to_local().numpy(), whole), path
            assert path in saved[part]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "kimi-k2-1t-a32b"])
def test_one_by_one_mesh_step_equals_the_plain_step(one_rank_mesh, arch):
    cfg = port_config(arch).replace(num_layers=1 if arch == "kimi-k2-1t-a32b" else 2)
    opt = make_optimizer(cfg.optimizer)
    rules = make_rules(cfg, ShapeConfig("t", 32, 4, "train"), MeshLayout(("data", "model"),
                                                                         (1, 1)))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             make_batch(jax_config(arch), 4, 32).items()}
    plain, pm = build_train_step(cfg, None, None, opt)(init_state(cfg, opt, "cpu"), batch)
    state = init_state(cfg, opt, "cpu", mesh=one_rank_mesh, rules=rules)
    from repro_torch.data.pipeline import device_put_batch
    new, m = build_train_step(cfg, one_rank_mesh, rules, opt)(
        state, device_put_batch(batch, "cpu", one_rank_mesh, rules))
    assert torch.equal(m["loss"], pm["loss"]) and torch.equal(m["grad_norm"], pm["grad_norm"])
    for a, b in zip(tree_leaves(new), tree_leaves(plain), strict=True):
        assert torch.equal(a.to_local(), b)


def test_one_by_one_mesh_engine_equals_the_plain_engine(one_rank_mesh):
    cfg = port_config("llama3.2-1b")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 24))
    plain = ServeEngine(cfg, 32, 4, device="cpu").generate(toks, 6)
    eng = ServeEngine(cfg, 32, 4, device="cpu", mesh=one_rank_mesh)
    calls = []
    real = dec_kernel.decode_attention_lse_plain
    dec_kernel.decode_attention_lse_plain = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        got = eng.generate(toks, 6)
    finally:
        dec_kernel.decode_attention_lse_plain = real
    assert np.array_equal(got, plain)
    assert len(calls) == 6 * cfg.num_layers


def test_stream_is_generate_a_token_at_a_time(one_rank_mesh):
    """``ServeEngine.stream`` of the plain and the 1 x 1 engine, stepped
    alternately (as chip_smoke.py times them), yields generate's tokens;
    too many tokens raise when the stream is made, before any step runs."""
    cfg = port_config("llama3.2-1b")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 24))
    engines = [ServeEngine(cfg, 32, 4, device="cpu"),
               ServeEngine(cfg, 32, 4, device="cpu", mesh=one_rank_mesh)]
    want = engines[0].generate(toks, 6)
    streams = [eng.stream(toks, 6) for eng in engines]
    got = [[], []]
    for _ in range(6):
        for i in (0, 1):
            got[i].append(next(streams[i]).numpy())
    for i in (0, 1):
        assert next(streams[i], None) is None
        assert np.array_equal(np.concatenate(got[i], axis=1), want)
        assert engines[i].generate(toks, 0).shape == (4, 0)
        with pytest.raises(ValueError, match="exceed"):
            engines[i].stream(toks, engines[i].slots - 24 + 1)
