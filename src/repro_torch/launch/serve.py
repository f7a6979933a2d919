"""Serving launcher: batched greedy prefill + decode on one card, or over
a ``torch.distributed`` mesh (PyTorch port of ``repro.launch.serve``).

The engine exposes the two phases the paper characterizes (prompt = a
compute spike, token = a flat memory-bound draw). ``--report-power`` logs
the Figure-4-style phase profile of the served model from the analytic
power model POLCA's simulator uses: the paper's modelled A100 server, not a
measurement of the card this runs on. The launcher's lines go to stderr
through the shared logger (:mod:`repro_torch.obs.log`), as the reference's
do; stdout stays clean.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --requests 8 --prompt 1024 --out-tokens 128 --report-power

With ``--data-par``/``--model-par`` (or under ``torchrun``) the engine
runs over a ``data x model`` ``DeviceMesh``, one rank a process (NCCL on
the card, gloo with ``--device cpu``): the prefill under the serve rules,
decode under the decode rules (a cache split by sequence over ``model``,
token-routed experts); every rank ends with the same tokens. An arch
outside the sharded step's slice raises ``NotImplementedError`` (ROADMAP
Queue 1 item 4d) and is never served unsharded instead.

  torchrun --nproc-per-node 8 -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --data-par 2 --model-par 4 --prompt 24 --out-tokens 8

An encoder-decoder model (flan-t5-xxl, whisper-base) is served with
seeded encoder inputs of the JAX launcher's length, a vision stub
(internvl2-1b) with seeded image embeddings, and an encoder-only model
(roberta-large) with ``--out-tokens 0``: the prefill alone.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.power_model import A100, ServerPower
from repro_torch.core.workload import request_timing
from repro_torch.device import resolve_device
from repro_torch.launch.inputs import make_rules, split_seq
from repro_torch.launch.mesh import layout_of, make_device_mesh, make_local_mesh
from repro_torch.launch.steps import (build_decode_step, build_prefill_step, decoder_slots,
                                     model_param_specs, state_specs, to_local)
from repro_torch.models import model as model_mod
from repro_torch.models.config import ShapeConfig
from repro_torch.models.param import distribute, init_params, placements, pspec
from repro_torch.obs.log import get_logger
from repro_torch.parallel import collectives as coll

log = get_logger(__name__)


class ServeEngine:
    """Greedy serving of ``batch`` sequences of up to ``max_len`` tokens.

    Parameters are drawn from ``seed`` on ``device`` (the CUDA card unless
    ``device="cpu"``), each leaf cast as it is drawn, so that every weight
    but the norm scales is kept in the activation dtype
    (:func:`~repro_torch.models.model.cast_weights`); ``params`` may be
    replaced by any tree of the same layout, such as
    :func:`~repro_torch.models.model.load_jax_params`'s. ``max_len`` is
    the shape's sequence length: an encoder-decoder model's decoder cache
    holds :func:`~repro_torch.launch.steps.decoder_slots` of it.

    Given a ``DeviceMesh`` (``mesh``), ``params`` are DTensors, one copy,
    laid out by the serve rules of the phase that ran last: the prefill
    shape's, or the decode shape's (token-routed experts over every axis).
    The two differ only in the MoE expert weights (gather mode splits the
    expert slots over ``model`` and their d_model dim over the data axes,
    token routing splits the slots over every axis), which are resharded
    when the phase changes (:meth:`_laid_out`), a whole leaf at a time. The
    prefill writes the cache in the decode rules' layout (``kv_seq``).
    ``params``, whole tensors of the layout the seed would draw, are taken
    instead of drawing them (two engines sharing one model's weights)."""

    def __init__(self, cfg, max_len: int, batch: int, device="cuda", seed: int = 0,
                 mesh=None, params=None):
        self.cfg, self.mesh = cfg, mesh
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.slots = decoder_slots(cfg, max_len)
        prefill = ShapeConfig("serve", max_len, batch, "prefill")
        if mesh is None:
            self.params = params if params is not None else init_params(
                model_mod.cast_weights(cfg, model_mod.model_specs(cfg)), gen)
            self.prefill = build_prefill_step(cfg, prefill)
            self.decode = build_decode_step(cfg)
            return
        layout = layout_of(mesh)
        self.decode_rules = make_rules(cfg, ShapeConfig("serve", max_len, batch, "decode"),
                                       layout)
        self.rules = {**make_rules(cfg, prefill, layout), "kv_seq": self.decode_rules["kv_seq"]}
        model_mod.check_sharded(cfg, model_mod.MeshCtx(mesh, self.decode_rules))
        whole = params if params is not None else init_params(
            model_mod.cast_weights(cfg, model_param_specs(cfg, mesh, self.rules)), gen)
        self.specs = {phase: state_specs(cfg, mesh, rules)["params"]
                      for phase, rules in (("prefill", self.rules), ("decode", self.decode_rules))}
        self.params = _relayout(whole, self.specs["prefill"], mesh)
        self.phase = "prefill"
        self.prefill = build_prefill_step(cfg, prefill, mesh, self.rules)
        self.decode = build_decode_step(cfg, mesh, self.decode_rules)

    def generate(self, tokens: np.ndarray, n_out: int, extra_inputs=None) -> np.ndarray:
        """Greedy decode. tokens: [B, S] ints; ``extra_inputs`` the model's
        other inputs by name, arrays or tensors: ``enc_embeds`` [B, enc_S,
        D] of an encoder-decoder model (any enc_S), ``image_embeds`` [B,
        Ni, D] of a vision stub. Returns [B, n_out] int32; ``n_out = 0``
        runs the prefill alone (an encoder-only model is served so).

        Decode starts at position Ni + S, after the image and the prompt
        (the JAX engine starts at S, where its first step overwrites a
        cached position). Raises ``ValueError`` before the prefill if the
        Ni + S + n_out positions exceed the decoder cache's slots (the JAX
        cache update clamps past its end)."""
        outs = list(self.stream(tokens, n_out, extra_inputs))
        if not outs:
            return np.zeros((np.shape(tokens)[0], 0), np.int32)
        return torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)

    def stream(self, tokens: np.ndarray, n_out: int, extra_inputs=None):
        """:meth:`generate`'s tokens one at a time, as an iterator of [B, 1]
        tensors on the device: the first once the prefill has run, each
        next one once a decode step has (the n_out-th step runs when the
        iterator is asked past its last token). Raises ``ValueError`` here,
        before anything runs, where :meth:`generate` does."""
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=self.device)
        batch = {"tokens": toks}
        for name, x in (extra_inputs or {}).items():
            batch[name] = torch.as_tensor(x, device=self.device)
        pos = toks.shape[1]
        if self.cfg.frontend == "vision_stub":
            pos += batch["image_embeds"].shape[1]
        if pos + n_out > self.slots:
            raise ValueError(f"{self.cfg.name}: {pos} prompt positions and {n_out} new "
                             f"tokens exceed the decoder cache's {self.slots} slots")
        if self.mesh is not None:
            return self._stream_sharded(batch, pos, n_out)
        return self._stream(batch, pos, n_out)

    def _stream(self, batch, pos: int, n_out: int):
        logits, cache = self.prefill(self.params, batch)
        tok = logits[:, -1, :].argmax(dim=-1, keepdim=True)
        for i in range(n_out):
            yield tok
            logits, cache = self.decode(self.params, tok, pos + i, cache)
            tok = logits[:, -1, :].argmax(dim=-1, keepdim=True)

    def _stream_sharded(self, batch, pos: int, n_out: int):
        """:meth:`_stream` over the mesh: each step's logits are gathered
        whole (outside the step) for the greedy pick, and the next token is
        split over the decode rules' batch axes again."""
        def place(x, rules):
            return distribute(x, pspec(rules.get("batch"), *([None] * (x.dim() - 1))),
                              self.mesh)

        logits, cache = self.prefill(self._laid_out("prefill"),
                                     {k: place(v, self.rules) for k, v in batch.items()})
        tok = coll.full_tensor(logits)[:, -1, :].argmax(dim=-1, keepdim=True)
        params = self._laid_out("decode") if n_out else None
        for i in range(n_out):
            yield tok
            logits, cache = self.decode(params, place(tok, self.decode_rules), pos + i, cache)
            tok = coll.full_tensor(logits)[:, -1, :].argmax(dim=-1, keepdim=True)

    def _laid_out(self, phase: str):
        """The rank's parameter blocks in ``phase``'s layout (the steps take
        local blocks as they are), the leaves whose placements differ
        resharded first when the phase changes."""
        if phase != self.phase:
            self.params = _relayout(self.params, self.specs[phase], self.mesh)
            self.phase = phase
        return to_local(self.params)


def _relayout(tree, specs, mesh):
    """``tree`` (whole tensors, or DTensors) as DTensors of this rank's
    blocks by ``specs``: a DTensor already so placed is kept as it is,
    another is made whole (``collectives.full_tensor``) and cut again, one
    leaf at a time."""
    if isinstance(tree, dict):
        return {k: _relayout(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, DTensor):
        if tuple(tree.placements) == tuple(placements(specs, mesh)):
            return tree
        tree = coll.full_tensor(tree)
    return distribute(tree, specs, mesh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--out-tokens", type=int, default=32)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--report-power", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    max_len = args.prompt + args.out_tokens
    if cfg.frontend == "vision_stub":  # the decoder also holds the image
        max_len += cfg.num_image_embeds
    mesh = None
    if args.data_par * args.model_par > 1 or "WORLD_SIZE" in os.environ:
        layout = make_local_mesh(args.data_par, args.model_par)
        rules = make_rules(cfg, ShapeConfig("serve", max_len, args.requests, "decode"), layout)
        model_mod.check_sharded(cfg, model_mod.MeshCtx(layout, rules))
        mesh = make_device_mesh(args.data_par, args.model_par, args.device)
    eng = ServeEngine(cfg, max_len, args.requests, device=args.device, mesh=mesh)

    rng = np.random.default_rng(0)
    extra = {}
    if cfg.is_encoder_decoder:
        enc_S, _ = split_seq(cfg, args.prompt + args.out_tokens)
        extra["enc_embeds"] = torch.tensor(
            rng.standard_normal((args.requests, enc_S, cfg.d_model)), dtype=torch.bfloat16)
    elif cfg.frontend == "vision_stub":
        extra["image_embeds"] = torch.tensor(
            rng.standard_normal((args.requests, cfg.num_image_embeds, cfg.d_model)),
            dtype=torch.bfloat16)
    tokens = rng.integers(0, cfg.vocab_size, (args.requests, args.prompt)).astype(np.int32)
    t0 = time.perf_counter()
    out = eng.generate(tokens, args.out_tokens, extra)
    dt = time.perf_counter() - t0
    step = (f" ({dt / args.out_tokens * 1e3:.1f} ms/token step)" if args.out_tokens
            else " (prefill only)")
    log.info(f"served batch={args.requests} prompt={args.prompt} out={args.out_tokens} "
             f"on {eng.device} in {dt:.2f}s{step}")
    log.info("sample output tokens: %s", out[0, :16])

    if args.report_power:
        # Figure-4-style phase profile from the shared workload/power model
        server = ServerPower(A100)
        full = get_config(args.arch)
        t = request_timing(full, args.prompt, args.requests, server)
        log.info(f"[power, modelled A100 server] {full.name}: prompt phase "
                 f"{t.t_prefill:.3f}s @ {t.prefill_point.power_at(server, 1.0):.0f}W "
                 f"(compute-bound u_c={t.prefill_point.u_compute:.2f}) | token phase "
                 f"{t.t_token * 1e3:.1f}ms/tok @ {t.token_point.power_at(server, 1.0):.0f}W "
                 f"(memory-bound u_m={t.token_point.u_memory:.2f})")


if __name__ == "__main__":
    main()
