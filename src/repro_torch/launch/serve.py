"""Serving launcher: batched greedy prefill + decode on one card (PyTorch
port of ``repro.launch.serve``).

The engine exposes the two phases the paper characterizes (prompt = a
compute spike, token = a flat memory-bound draw). ``--report-power`` logs
the Figure-4-style phase profile of the served model from the analytic
power model POLCA's simulator uses: the paper's modelled A100 server, not a
measurement of the card this runs on. The launcher's lines go to stderr
through the shared logger (:mod:`repro_torch.obs.log`), as the reference's
do; stdout stays clean.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --requests 8 --prompt 1024 --out-tokens 128 --report-power

An encoder-decoder model (flan-t5-xxl, whisper-base) is served with
seeded encoder inputs of the JAX launcher's length, a vision stub
(internvl2-1b) with seeded image embeddings, and an encoder-only model
(roberta-large) with ``--out-tokens 0``: the prefill alone.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.power_model import A100, ServerPower
from repro_torch.core.workload import request_timing
from repro_torch.device import resolve_device
from repro_torch.launch.inputs import split_seq
from repro_torch.launch.steps import build_decode_step, build_prefill_step, decoder_slots
from repro_torch.models import model as model_mod
from repro_torch.models.config import ShapeConfig
from repro_torch.models.param import init_params
from repro_torch.obs.log import get_logger

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
    holds :func:`~repro_torch.launch.steps.decoder_slots` of it."""

    def __init__(self, cfg, max_len: int, batch: int, device="cuda", seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = init_params(
            model_mod.cast_weights(cfg, model_mod.model_specs(cfg)), gen)
        self.prefill = build_prefill_step(cfg, ShapeConfig("serve", max_len, batch, "prefill"))
        self.decode = build_decode_step(cfg)
        self.slots = decoder_slots(cfg, max_len)

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
        logits, cache = self.prefill(self.params, batch)
        tok = logits[:, -1, :].argmax(dim=-1, keepdim=True)
        outs = [tok[:, :0]]  # [B, 0]: the result of n_out = 0
        for i in range(n_out):
            outs.append(tok)
            logits, cache = self.decode(self.params, tok, pos + i, cache)
            tok = logits[:, -1, :].argmax(dim=-1, keepdim=True)
        return torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--out-tokens", type=int, default=32)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--report-power", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.model_par != 1:
        raise NotImplementedError("--model-par > 1: tensor parallelism waits "
                                  "for ROADMAP Queue 1 item 4c")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    max_len = args.prompt + args.out_tokens
    if cfg.frontend == "vision_stub":  # the decoder also holds the image
        max_len += cfg.num_image_embeds
    eng = ServeEngine(cfg, max_len, args.requests, device=args.device)

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
