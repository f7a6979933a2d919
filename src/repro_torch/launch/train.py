"""Training launcher: the train step under :class:`~repro_torch.runtime.
fault_tolerance.TrainSupervisor` on one device or over a
``torch.distributed`` mesh (PyTorch port of ``repro.launch.train``).

Parameters are drawn from a seed on the device (the CUDA card unless
``--device cpu``), the data is the seeded synthetic pipeline, and the run
checkpoints every ``--ckpt-interval`` steps into ``--ckpt-dir``, restoring
and replaying from the newest checkpoint after a failed step (``--fail-at``
injects such failures). The launcher asserts that the loss fell over the
run, as the reference does, and writes the per-step history (step,
seconds, loss, grad norm) to ``--history`` when given. Its lines go to
stderr through the shared logger.

  PYTHONPATH=src python -m repro_torch.launch.train --arch roberta-large \\
      --batch 32 --seq 2048 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke \\
      --steps 60 --batch 8 --seq 64 --device cpu

With ``--data-par``/``--model-par`` (or under ``torchrun``) the step runs
over a ``data x model`` ``DeviceMesh``, one rank a process (NCCL on the
card, gloo with ``--device cpu``), its state and batches DTensors laid out
by the train rules (``make_rules``); the checkpoints hold whole arrays. An
arch outside the sharded step's slice raises ``NotImplementedError``
(ROADMAP Queue 1 item 4d) and never trains unsharded instead.

  torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --steps 4 --batch 8 --seq 64 --device cpu --data-par 2 --model-par 4
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline, device_put_batch
from repro_torch.device import resolve_device
from repro_torch.launch.inputs import make_rules
from repro_torch.launch.mesh import layout_of, make_device_mesh, make_local_mesh
from repro_torch.launch.steps import build_train_step, init_state
from repro_torch.models import model as model_mod
from repro_torch.models.config import ShapeConfig
from repro_torch.obs.log import get_logger
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.runtime.fault_tolerance import FaultInjector, StragglerMonitor, TrainSupervisor

log = get_logger(__name__)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="out/train_ckpt")
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--history", default=None, help="write the step history here (JSON)")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject a fault before the n-th step run (replays counted), "
                         "once each: exercises restore and replay")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def run(argv=None):
    """Parse ``argv``, train, and return (final state, supervisor); the
    supervisor's ``history`` has one entry a step run."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt = make_optimizer(cfg.optimizer)
    mesh = rules = None
    if args.data_par * args.model_par > 1 or "WORLD_SIZE" in os.environ:
        layout = make_local_mesh(args.data_par, args.model_par)
        rules = make_rules(cfg, ShapeConfig("cli_train", args.seq, args.batch, "train"), layout)
        model_mod.check_sharded(cfg, model_mod.MeshCtx(layout, rules))
        mesh = make_device_mesh(args.data_par, args.model_par, device)
    state = init_state(cfg, opt, device, mesh=mesh, rules=rules)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    where = f"mesh={layout_of(mesh).label}" if mesh is not None else f"device={device}"
    log.info(f"arch={cfg.name} params={n_params / 1e6:.1f}M optimizer={opt.name} {where}")

    pipeline = SyntheticTokenPipeline(cfg, DataConfig(args.batch, args.seq))
    train_step = build_train_step(cfg, mesh, rules, opt)
    faults = FaultInjector(args.fail_at)

    def step_fn(state, batch):
        faults.maybe_fail(len(sup.history))
        return train_step(state, batch)

    sup = TrainSupervisor(step_fn, pipeline, args.ckpt_dir,
                          ckpt_interval=args.ckpt_interval, straggler=StragglerMonitor())
    t0 = time.time()
    state, last = sup.run(state, args.steps,
                          place_batch=lambda b: device_put_batch(b, device, mesh, rules))
    dt = time.time() - t0
    losses = [h["loss"] for h in sup.history]
    step_s = statistics.median(h["dt"] for h in sup.history) if sup.history else 0.0
    first_s = sup.history[0]["dt"] if sup.history else 0.0
    log.info(f"done: {last} steps in {dt:.1f}s (median {step_s:.3f}s/step; the first, "
             f"with one-time set-up such as the kernel build, {first_s:.3f}s) "
             f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
             f"restarts={sup.n_restarts} stragglers={len(sup.straggler.flagged_steps)}")
    if args.history:
        with open(args.history, "w") as f:
            json.dump(sup.history, f)
    return state, sup


def main(argv=None):
    """The launcher: :func:`run`, then the reference's check that the loss
    fell over the run. Returns the step history."""
    _, sup = run(argv)
    losses = [h["loss"] for h in sup.history]
    assert losses[-1] < losses[0], "training should reduce loss"
    return sup.history


if __name__ == "__main__":
    main()
