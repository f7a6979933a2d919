"""One rank of ``tests/test_torch_sharded.py``'s gloo world (imports torch
and the port, never JAX).

Run as ``python tests/_torch_sharded_worker.py TASKS OUT`` with ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set, one process a rank
of a (2, 4) ``("data", "model")`` mesh. ``TASKS`` is a pickle the test
writes: the cells (arch, config overrides, the shared parameters and
inputs as numpy arrays) and the directories of the checkpoint and launcher
runs. The rank runs every cell's sharded step and writes what it holds,
its local blocks and their specs, the collectives of each cell's step
(``launch.dryrun.count_collectives``) and the MoE rows it dropped, to
``OUT/rank<r>.pkl``.
"""

import os
import pickle
import sys
import traceback
import warnings

import numpy as np
import torch

warnings.filterwarnings("ignore")
torch.set_num_threads(1)

from repro_torch.checkpoint import checkpointer  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.inputs import make_rules  # noqa: E402
from repro_torch.launch.mesh import layout_of, make_device_mesh  # noqa: E402
from repro_torch.launch.steps import (build_decode_step, build_prefill_step,  # noqa: E402
                                      build_train_step, loss_and_grads, state_specs,
                                      to_local)
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.param import distribute, pspec, spec_of  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.runtime.fault_tolerance import elastic_reshard  # noqa: E402


def config(arch, over):
    cfg = smoke_config(arch)
    over = {k: getattr(torch, v) if k in ("dtype", "param_dtype") else v
            for k, v in over.items()}
    return cfg.replace(**over)


def place_tree(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: place_tree(tree[k], specs[k], mesh) for k in tree}
    return distribute(torch.as_tensor(np.asarray(tree, np.float32)), specs, mesh)


def cast_tree(tree, like):
    if isinstance(tree, dict):
        return {k: cast_tree(tree[k], like[k]) for k in tree}
    return torch.as_tensor(np.asarray(tree, np.float32)).to(like.dtype)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def blocks(tree):
    """{path: (local numpy block, spec)} of a DTensor tree."""
    out = {}
    for path, x in flat(tree).items():
        out[path] = (x.to_local().detach().float().numpy().copy(),
                     spec_of(x))
    return out


class Drops:
    """Counts the MoE rows ``moe.dispatch`` cuts at the capacity while it
    is entered: the rows routed to the rank's experts less the rows kept."""

    def __enter__(self):
        self.n, self.dispatch = 0, moe.dispatch

        def counting(cfg, topi, e_start=0, n_local=0, e_shards=1):
            sel, sizes = self.dispatch(cfg, topi, e_start, n_local, e_shards)
            n_local = n_local or cfg.moe_num_experts
            mine = (topi >= e_start) & (topi < e_start + n_local)
            self.n += int(mine.sum()) - sum(sizes)
            return sel, sizes

        moe.dispatch = counting
        return self

    def __exit__(self, *exc):
        moe.dispatch = self.dispatch


def counted(cfg, shape, mesh):
    stats = dryrun.count_collectives(cfg, shape, mesh)
    return {"ops": dict(stats.ops), "bytes": dict(stats.bytes_by_kind)}


def train_cell(cell, mesh, B, S):
    cfg = config(cell["arch"], cell["over"])
    opt = make_optimizer(cfg.optimizer)
    rules = make_rules(cfg, ShapeConfig("t", S, B, "train"), layout_of(mesh))
    specs = state_specs(cfg, mesh, rules, opt)
    plain = train_mod.init_state(cfg, opt, "cpu")  # the dtypes and the zero state
    state = {"params": place_tree(cast_tree(cell["params"], plain["params"]),
                                  specs["params"], mesh),
             "opt": place_tree(plain["opt"], specs["opt"], mesh)}
    batch = {k: distribute(torch.from_numpy(v), pspec(rules.get("batch"),
                                                      *([None] * (v.ndim - 1))), mesh)
             for k, v in cell["batch"].items()}
    ctx = model_mod.MeshCtx(mesh, rules)
    with Drops() as drops:
        loss, grads = loss_and_grads(cfg, to_local(state["params"]), to_local(batch), ctx)
    new, metrics = build_train_step(cfg, mesh, rules, opt)(state, batch)
    held, grads = blocks(state["params"]), flat(grads)
    grads = {p: (grads[p].float().numpy().copy(), spec) for p, (_, spec) in held.items()}
    return {"loss": float(metrics["loss"]), "grad_loss": float(loss),
            "grad_norm": float(metrics["grad_norm"]), "grads": grads,
            "params": blocks(new["params"]), "opt": blocks(new["opt"]),
            "collectives": counted(cfg, ShapeConfig("t", S, B, "train"), mesh),
            "dropped": drops.n}, new


def serve_cell(cell, mesh, B, S):
    cfg = config(cell["arch"], cell["over"])
    n = cell["tokens"].shape[0]
    layout = layout_of(mesh)
    pre_rules = make_rules(cfg, ShapeConfig("t", S + n, B, "prefill"), layout)
    dec_rules = make_rules(cfg, ShapeConfig("t", S + n, B, "decode"), layout)
    pre_rules = {**pre_rules, "kv_seq": dec_rules["kv_seq"]}
    out = {}
    params_p = place_tree(cell["params"], state_specs(cfg, mesh, pre_rules)["params"], mesh)
    params_d = place_tree(cell["params"], state_specs(cfg, mesh, dec_rules)["params"], mesh)
    prefill = build_prefill_step(cfg, ShapeConfig("t", S + n, B, "prefill"), mesh, pre_rules)
    decode = build_decode_step(cfg, mesh, dec_rules)

    def place(x, rules):
        x = torch.from_numpy(np.asarray(x))
        return distribute(x, pspec(rules.get("batch"), *([None] * (x.dim() - 1))), mesh)

    with torch.no_grad(), Drops() as drops:
        logits, cache = prefill(params_p, {"tokens": place(cell["prompt"], pre_rules)})
        out["prefill_dropped"] = drops.n
        out["prefill_logits"] = blocks({"x": logits})["x"]
        out["cache"] = blocks(cache)
        out["decode_logits"] = []
        for i in range(n):
            logits, cache = decode(params_d, place(cell["tokens"][i], dec_rules), S + i, cache)
            out["decode_logits"].append(blocks({"x": logits})["x"])
    out["dropped"] = drops.n
    out["prefill_collectives"] = counted(cfg, ShapeConfig("t", S, B, "prefill"), mesh)
    out["decode_collectives"] = counted(cfg, ShapeConfig("t", S + n, B, "decode"), mesh)
    return out


def checkpoint_cell(state, ckpt_dir):
    """Save a sharded state whole, restore it onto the same (2, 4) mesh
    through ``elastic_reshard`` and compare every rank's blocks bit for
    bit."""
    path = checkpointer.save(ckpt_dir, 1, state)
    with np.load(path) as data:
        host = {}
        for k in data.files:
            if k == "__step__":
                continue
            node = host
            *head, last = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = data[k]
    back = elastic_reshard(lambda mesh: state, host, state["params"]["embed"].device_mesh)
    same = all(torch.equal(a.to_local(), b.to_local())
               for a, b in zip(flat(state).values(), flat(back).values()))
    return {"path": path, "bit_identical": same}


def engine_relayout(mesh, arch, over):
    """The sharded ServeEngine holds one copy of the weights: two generates
    (prefill layout, decode layout, and back), the leaves each phase
    change moved, and the blocks after a round trip."""
    cfg = config(arch, over)
    eng = serve_mod.ServeEngine(cfg, 32, 8, device="cpu", mesh=mesh)
    before = blocks(eng.params)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (8, 16))
    first = eng.generate(toks, 4)
    decode = blocks(eng.params)
    second = eng.generate(toks, 4)
    phase = eng.phase
    eng._laid_out("prefill")
    after = blocks(eng.params)
    return {"tokens": [first, second], "phase": phase,
            "moved": sorted(p for p in before if before[p][1] != decode[p][1]),
            "decode_specs": {p: decode[p][1] for p in decode},
            "round_trip": all(np.array_equal(before[p][0], after[p][0])
                              and before[p][1] == after[p][1] for p in before)}


def launchers(dirs):
    out = {}
    _, sup = train_mod.run(["--arch", "llama3.2-1b", "--smoke", "--steps", "3", "--batch",
                            "8", "--seq", "32", "--device", "cpu", "--data-par", "2",
                            "--model-par", "4", "--ckpt-dir", dirs["train"],
                            "--ckpt-interval", "2"])
    out["train_losses"] = [h["loss"] for h in sup.history]
    serve_mod.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--data-par", "2",
                    "--model-par", "4", "--requests", "8", "--prompt", "16",
                    "--out-tokens", "3"])
    out["serve"] = True
    for arch in ("mamba2-370m", "gemma2-9b", "whisper-base"):
        try:
            train_mod.run(["--arch", arch, "--smoke", "--steps", "1", "--batch", "8",
                           "--seq", "32", "--device", "cpu", "--data-par", "2",
                           "--model-par", "4", "--ckpt-dir", dirs["train"]])
            out[arch] = "ran"
        except NotImplementedError as e:
            out[arch] = str(e)
    return out


def main(tasks_path, out_dir):
    with open(tasks_path, "rb") as f:
        tasks = pickle.load(f)
    mesh = make_device_mesh(2, 4, "cpu")
    rank = torch.distributed.get_rank()
    B, S = tasks["B"], tasks["S"]
    result = {"coords": dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())),
              "train": {}, "serve": {}}
    try:
        for cell in tasks["train"]:
            result["train"][cell["arch"]], new = train_cell(cell, mesh, B, S)
            if cell["arch"] == tasks["checkpoint_arch"]:
                result["checkpoint"] = checkpoint_cell(new, tasks["ckpt_dir"])
                result["checkpoint"]["state"] = {"params": blocks(new["params"]),
                                                 "opt": blocks(new["opt"])}
        for cell in tasks["serve"]:
            result["serve"][cell["arch"]] = serve_cell(cell, mesh, B, S)
        result["launchers"] = launchers(tasks["launch_dirs"])
        result["engine"] = engine_relayout(mesh, tasks["engine_arch"], tasks["engine_over"])
    except Exception:
        result["error"] = traceback.format_exc()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        raise
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
