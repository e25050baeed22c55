"""Serving launcher: batched greedy decoding with a KV cache (dense, moe),
a recurrent state (ssm), both (hybrid), or a KV cache and the encoder's
cross K/V (audio).

    PYTHONPATH=src python -m repro_torch.launch.serve --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-moe-16b --param-dtype bfloat16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi-3-vision-4.2b
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

``--param-dtype`` is the held weights' dtype (``RunConfig.param_dtype`` in
the reference, float32 by default); deepseek-moe-16b's 16.4 B parameters
fit one 80 GB card only as bf16.

The audio family gets the reference's stub frames (``repro.launch.serve``):
(batch, prompt-len, d_model) filled with 0.01 in float32, so its encoder
runs in float32.  The vlm family is served on tokens alone, as the
reference's launcher serves it: its ``prefill`` and ``decode_step`` take no
patch embeddings.

Runs on the card unless ``--device cpu`` is given.  The first generated
token comes from prefill, the other ``gen - 1`` from decode steps, as in
``repro.launch.serve``.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, reduced
from ..device import resolve_device
from ..kernels import flash_attention as fa
from ..kernels import rwkv6
from ..models.transformer import LM
from ..serve.decode import decode_step, prefill


def make_prompts(cfg, batch: int, prompt_len: int, seed: int = 0, *,
                 device="cuda") -> torch.Tensor:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    return torch.as_tensor(toks, dtype=torch.long,
                           device=resolve_device(device))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class ServeResult:
    tokens: torch.Tensor        # (B, gen) generated tokens
    last_logits: torch.Tensor   # (B, 1, V) logits that chose the last token
    prefill_s: float
    decode_s: float             # all gen - 1 decode steps


def generate(lm: LM, prompts: torch.Tensor, gen: int,
             frame_embeds: Optional[torch.Tensor] = None,
             max_len: Optional[int] = None) -> ServeResult:
    """Greedy decoding: prefill the prompts, then ``gen - 1`` decode steps.

    ``max_len`` (default prompt + ``gen``) is the caches' capacity, which
    for the audio family also bounds the cross K/V (``frame_embeds``
    (B, S_enc, D), encoded in their own dtype from the held weights, as the
    reference's prefill encodes them from its params)."""
    cfg, params = lm.cfg, lm.compute_params()
    with torch.inference_mode():
        _sync(prompts.device)
        t0 = time.perf_counter()
        logits, state = prefill(
            params, cfg, prompts, max_len=max_len or prompts.shape[1] + gen,
            frame_embeds=frame_embeds,
            encoder_params=lm.params if cfg.is_encoder_decoder else None)
        tok = logits.argmax(dim=-1)
        _sync(prompts.device)
        t1 = time.perf_counter()
        out = [tok]
        for _ in range(gen - 1):
            logits, state = decode_step(params, cfg, tok, state)
            tok = logits.argmax(dim=-1)
            out.append(tok)
        _sync(prompts.device)
        t2 = time.perf_counter()
    return ServeResult(torch.cat(out, dim=1), logits, t1 - t0, t2 - t1)


def main(argv: Optional[Sequence[str]] = None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--param-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)
    if args.gen < 1:
        ap.error("--gen must be >= 1")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    lm = LM.init(cfg, seed=0, device=args.device,
                 dtype=getattr(torch, args.param_dtype))
    prompts = make_prompts(cfg, args.batch, args.prompt_len, seed=0,
                           device=args.device)
    frames = None
    if cfg.frontend == "frames":      # the reference's stub frames
        frames = torch.full((args.batch, args.prompt_len, cfg.d_model), 0.01,
                            dtype=torch.float32, device=prompts.device)
    fa.launches = rwkv6.launches = 0
    res = generate(lm, prompts, args.gen, frames)
    print(f"[serve] {cfg.name} on {prompts.device}, {args.param_dtype} "
          f"weights: prefill {args.batch}x{args.prompt_len} tokens in "
          f"{res.prefill_s * 1e3:.1f} ms")
    steps = args.gen - 1
    if steps:
        print(f"[serve] {steps} decode steps x {args.batch}: "
              f"{res.decode_s / steps * 1e3:.2f} ms/step, "
              f"{steps * args.batch / res.decode_s:.1f} tok/s")
    for name, mod in (("flash-attention", fa), ("rwkv6", rwkv6)):
        print(f"[serve] {name} kernel launches: {mod.launches}")
    print("[serve] sample:", res.tokens[0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
