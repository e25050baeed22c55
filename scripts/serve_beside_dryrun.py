#!/usr/bin/env python3
"""Served time on the card, alone and beside ``chip_smoke.py``'s background
dry run, with two ``write_slots``.

Full width and depth, weights from seed 0, chip_smoke's serving shapes:
tinyllama-1.1b (bf16 weights) a prefill of 4 x 2048 tokens into a cache of
2057 slots; whisper-base (float32 masters, bf16 compute) 16 requests of
1500 seeded bf16 frames and a 224-token prompt into caches of 1536 rows;
then 8 greedy decode steps, timed on the host clock between
``torch.cuda.synchronize`` calls.  Each reading runs in
turns (parent, change, change, parent, twice) with the cache write of the
port before its slicing rewrite (``parent``: index tensors from a host
``arange``, copied to the card a call) and the port's own (``change``);
first alone, then while ``chip_smoke.start_dryrun``'s process (phase 7's
cells on fake cuda tensors) runs beside it.  Prints the prefill ms and
decode ms a step of every turn.  Needs one card.

    python3 scripts/serve_beside_dryrun.py
"""

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def parent_write_slots(cache, new, first):
    """The cache write before its slicing rewrite (one device)."""
    cap, n = cache.shape[1], new.shape[1]
    slots = torch.arange(first, first + n) % cap
    mine = (slots >= 0) & (slots < cap)
    dev = cache.device
    cache[:, slots[mine].to(dev)] = \
        new[:, mine.nonzero()[:, 0].to(dev)].to(cache.dtype)


def main() -> None:
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import decode, kv_cache
    from repro_torch.serve.decode import decode_step, greedy, prefill
    if not torch.cuda.is_available():
        raise SystemExit("serve_beside_dryrun: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    models = {}
    for arch, dtype, batch, prompt, max_len, frames in (
            ("tinyllama-1.1b", torch.bfloat16, 4, 2048, 2048 + 9, 0),
            ("whisper-base", torch.float32, cs.WHISPER_BATCH,
             cs.WHISPER_PROMPT, cs.WHISPER_MAX_LEN, cs.WHISPER_FRAMES)):
        cfg = get_config(arch)
        extra = {} if not frames else {"frame_embeds": torch.randn(
            (batch, frames, cfg.d_model), generator=gen, device=dev).to(
                torch.bfloat16)}
        models[arch] = (cfg, init_lm(cfg, 0, device=dev, dtype=dtype),
                        torch.randint(0, cfg.vocab_size, (batch, prompt),
                                      device=dev, generator=gen),
                        max_len, extra)
    change = kv_cache.write_slots

    def use(fn):
        """``fn`` for every cache write (kv_cache's and the cross cache's
        in ``serve.decode``, which imports the name)."""
        kv_cache.write_slots = decode.write_slots = fn

    def served(arch):
        cfg, params, toks, max_len, extra = models[arch]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = prefill(params, cfg, toks, max_len, **extra)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = greedy(logits[:, -1:])
        for _ in range(8):
            logits, state = decode_step(params, cfg, tok, state)
            tok = greedy(logits)
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) / 8 * 1e3

    with torch.no_grad():
        for fn in (change, parent_write_slots):      # warm-up
            use(fn)
            for arch in models:
                served(arch)
        started = None
        for phase in ("alone", "beside the dry run"):
            if phase != "alone":
                started = cs.start_dryrun()
                time.sleep(20)          # past the child's imports
            for name, fn in (("parent", parent_write_slots),
                             ("change", change), ("change", change),
                             ("parent", parent_write_slots)) * 2:
                use(fn)
                for arch in models:
                    pre, dec = served(arch)
                    print(f"{phase}: {arch} {name} write_slots: prefill "
                          f"{pre:.2f} ms, decode {dec:.3f} ms a step; {smi}",
                          flush=True)
        use(change)
        started[0].join(900)
        print(f"the dry run's process exited {started[0].exitcode}",
              flush=True)


if __name__ == "__main__":
    main()
