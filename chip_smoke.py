#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  1. device  — a CUDA card is required (no CPU fallback); prints its name and
               ``nvidia-smi``'s name and power limit.  TF32 is switched off
               for matmuls and cuDNN, so float32 plain versions are exact
               float32 references.
  2. build   — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``;
               prints build seconds and ptxas registers / shared memory.
  3. kernels — each kernel against its plain PyTorch version on the card, at
               the serving path's shape and at MHA / MQA / ragged /
               non-causal / windowed / other head-dim cases.
  4. serve   — full-width tinyllama-1.1b (22 layers, seeded random weights,
               bf16) through ``repro_torch.launch.serve.generate``: prefill of
               4 x 2048 tokens and 32 greedy decode steps.  The kernel must be
               launched once per layer by prefill.  Then a teacher-forced
               forward over prompt + generated tokens must reproduce the last
               decode logits.  torch.profiler then traces one prefill and 8
               decode steps: wall time, kernel time, device idle share and
               the kernels that take the most device time.
  5. timing  — each kernel, its plain version and a PyTorch library call
               computing the same function, at the path's shape (CUDA events).
The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BATCH, PROMPT, DECODE_STEPS = 4, 2048, 32
# Published dense peaks of one H100 SXM at its 700 W limit.
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
# Kernel vs plain: bf16 — the kernel rounds P to bf16 before the PV product
# (tests/test_kernels.py's bf16 bound); float32 — the same float32
# arithmetic summed in another order, with exp from the device library.
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Decode vs teacher-forced forward, bf16 (tests/test_serve.py:60-62).
SERVE_ATOL, SERVE_RTOL = 0.15, 0.05


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def live_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(q, k) pairs the masks leave: the work the kernel must do."""
    total = 0
    for q in range(sq):
        hi = min(skv, q + 1) if causal else skv
        lo = max(0, q - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def bound(q, k, v, causal, window):
    """Least time on the card: max(products / peak rate, bytes / memory rate)."""
    import torch
    b, sq, hq, hd = q.shape
    flops = 4.0 * hd * b * hq * live_pairs(sq, k.shape[1], causal, window)
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def serve_bounds(cfg, batch: int, prompt: int, steps: int):
    """Least time of the served path on the card, from its shapes.

    Prefill: the bf16 products of every layer matrix over all prompt tokens,
    the live attention pairs, and the lm_head at the last position, over the
    bf16 peak.  A decode step: the bytes it must read, i.e. every matrix
    once (bf16) plus the valid part of the KV cache (its mean over the
    steps), over the memory rate.  Returns (prefill_ms, decode_ms_per_step).
    """
    d, hd = cfg.d_model, cfg.head_dim_
    per_layer = (2 * d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd
                 + 3 * d * cfg.d_ff)
    mats = cfg.num_layers * per_layer
    head = d * cfg.vocab_size
    attn = (cfg.num_layers * 4 * hd * cfg.num_heads * batch
            * live_pairs(prompt, prompt, True, None))
    prefill = (2 * mats * batch * prompt + attn + 2 * head * batch)
    kv = cfg.num_layers * 2 * batch * (prompt + steps / 2) \
        * cfg.num_kv_heads * hd
    decode = 2 * (mats + head + kv)
    return prefill / PEAK_BF16_FLOPS * 1e3, decode / PEAK_BYTES * 1e3


def time_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(label: str, fn, top: int = 6) -> None:
    """Wall time, summed kernel time and the device's idle share of ``fn``
    under torch.profiler (which adds host time: the idle share it shows is
    an upper estimate), and the kernels that take most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    idle = 1 - busy_ms / wall_ms if busy_ms else float("nan")
    log(f"profile {label}: wall {wall_ms:.3f} ms, kernels {busy_ms:.3f} ms, "
        f"device idle share {idle:.3f}")
    for ms, count, key in rows[:top]:
        log(f"profile {label}:   {ms:9.3f} ms {count:6d}x {key[:90]}")


def profile_serve(lm, prompts, tokens) -> None:
    """Profile one prefill and 8 decode steps of the served model."""
    import torch
    from repro_torch.serve.decode import decode_step, prefill
    cfg, params = lm.cfg, lm.compute_params()
    max_len = prompts.shape[1] + 9
    with torch.inference_mode():
        box = {}
        device_profile("prefill", lambda: box.update(
            st=prefill(params, cfg, prompts, max_len)[1]))

        def decode8():
            st = box["st"]
            for i in range(8):
                st = decode_step(params, cfg, tokens[:, i:i + 1], st)[1]
        device_profile("decode x8", decode8)


def main() -> None:
    import torch

    # 1. device -------------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; the port's smoke run needs the card")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models.transformer import LM

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN: float32 plain versions are float32")

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    report = build.build_all()
    log(f"built {sorted(report)} in {time.perf_counter() - t0:.1f} s")
    for name, text in report.items():
        for line in text.splitlines():   # ptxas -v: one entry per variant
            entry = re.search(r"entry function '(\S+)'", line)
            if entry:
                log(f"ptxas {name}: {entry.group(1)}")
            elif "registers" in line or "spill" in line:
                log(f"ptxas {name}:   {line.strip()}")
    for dtype in (torch.bfloat16, torch.float32):
        sizes = {hd: fa.smem_bytes(dtype, hd) for hd in fa.HEAD_DIMS}
        log(f"flash_attention {dtype} dynamic shared memory per CTA "
            f"(bytes, by head_dim): {sizes}")

    # 3. kernels against their plain versions -------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, s, hq, hkv, hd, dtype):
        return [torch.randn((b, s, h, hd), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
                for h in (hq, hkv, hkv)]

    cases = [  # name, (B, S, Hq, Hkv, hd), dtype, causal, window
        ("path-bf16", (BATCH, PROMPT, 32, 4, 64), torch.bfloat16, True, None),
        ("path-f32", (BATCH, PROMPT, 32, 4, 64), torch.float32, True, None),
        ("mha", (2, 512, 8, 8, 64), torch.bfloat16, True, None),
        ("mqa", (2, 512, 8, 1, 64), torch.bfloat16, True, None),
        ("ragged-1000", (2, 1000, 8, 4, 64), torch.bfloat16, True, None),
        ("ragged-1000-f32", (2, 1000, 8, 4, 64), torch.float32, True, None),
        ("non-causal", (2, 1000, 8, 4, 64), torch.bfloat16, False, None),
        ("window-48", (2, 1000, 8, 4, 64), torch.bfloat16, True, 48),
        ("window-48-f32", (2, 1000, 8, 4, 64), torch.float32, True, 48),
        ("hd16", (1, 300, 4, 2, 16), torch.bfloat16, True, None),
        ("hd32", (1, 300, 4, 2, 32), torch.bfloat16, True, None),
        ("hd128", (1, 300, 4, 2, 128), torch.bfloat16, True, None),
        ("hd128-f32", (1, 300, 4, 2, 128), torch.float32, True, None),
    ]
    path_err = None
    for name, shape, dtype, causal, window in cases:
        q, k, v = qkv(*shape, dtype)
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        tol = TOL[str(dtype).split(".")[-1]]
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
            out.float(), ref.float(), atol=tol, rtol=tol)
        log(f"flash_attention {name:16s} {str(dtype):15s} max_abs_err "
            f"{err:.3e} (tol {tol:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"flash_attention {name}: kernel disagrees with its plain "
                 f"version (max_abs_err {err:.3e} > tol {tol:g})")
        if name == "path-bf16":
            path_err = err
        del q, k, v, out, ref
    torch.cuda.empty_cache()

    # 4. the main path: full-width tinyllama-1.1b serving -------------------
    cfg = get_config("tinyllama-1.1b")
    lm = LM.init(cfg, seed=0, device=dev)
    prompts = make_prompts(cfg, BATCH, PROMPT, seed=0, device=dev)
    log(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.2f} B params, {cfg.dtype}")
    generate(lm, prompts, 2)          # warm-up: allocator, cuBLAS, kernel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    res = generate(lm, prompts, DECODE_STEPS + 1)
    launches = fa.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"prefill {BATCH}x{PROMPT}: {res.prefill_s * 1e3:.2f} ms; "
        f"decode {res.decode_s / DECODE_STEPS * 1e3:.3f} ms/step, "
        f"{DECODE_STEPS * BATCH / res.decode_s:.1f} tok/s; "
        f"peak memory {peak_gb:.2f} GiB")
    pre_bound, dec_bound = serve_bounds(cfg, BATCH, PROMPT, DECODE_STEPS)
    log(f"serve bounds on the card: prefill {pre_bound:.3f} ms (operations), "
        f"decode {dec_bound:.4f} ms/step (bytes); measured / bound: prefill "
        f"{res.prefill_s * 1e3 / pre_bound:.2f}x, decode "
        f"{res.decode_s / DECODE_STEPS * 1e3 / dec_bound:.1f}x")
    log(f"flash_attention launches on the serve path: {launches}")
    if launches != cfg.num_layers:
        fail(f"prefill launched the kernel {launches} times, expected one per "
             f"layer ({cfg.num_layers})")
    if tuple(res.tokens.shape) != (BATCH, DECODE_STEPS + 1):
        fail(f"generated tokens of shape {tuple(res.tokens.shape)}")
    if not bool(torch.isfinite(res.last_logits.float()).all()):
        fail("decode logits are not finite")

    with torch.inference_mode():
        full = lm(torch.cat([prompts, res.tokens[:, :-1]], dim=1))[:, -1]
    torch.cuda.synchronize()
    tf_launches = fa.launches - launches
    dec = res.last_logits[:, 0].float()
    err = (full.float() - dec).abs().max().item()
    agree = (full.argmax(-1) == dec.argmax(-1)).float().mean().item()
    log(f"teacher-forced forward vs last decode logits: max_abs_err {err:.4f} "
        f"(atol {SERVE_ATOL}, rtol {SERVE_RTOL}); argmax agreement "
        f"{agree:.2f}; kernel launches {tf_launches}")
    if tf_launches != cfg.num_layers:
        fail(f"teacher-forced forward launched the kernel {tf_launches} times")
    if not torch.allclose(full.float(), dec, atol=SERVE_ATOL, rtol=SERVE_RTOL):
        fail("decode logits disagree with the teacher-forced forward")
    del full
    profile_serve(lm, prompts, res.tokens)
    del lm, res
    torch.cuda.empty_cache()

    # 5. timing at the path's shape -------------------------------------------
    q, k, v = qkv(BATCH, PROMPT, 32, 4, 64, torch.bfloat16)
    kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v), iters=5)
    # yardstick only, never called by the port: PyTorch's fused attention on
    # (B, H, S, hd) inputs with the kv heads expanded beforehand
    g = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True))
    bound_ms, bound_by = bound(q, k, v, True, None)
    log(f"flash_attention at the path's shape: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}); {smi}")
    qf, kf, vf = (t.float() for t in (q, k, v))
    f32_ms = time_ms(lambda: fa.flash_attention(qf, kf, vf), iters=5)
    f32_bound, f32_by = bound(qf, kf, vf, True, None)
    log(f"flash_attention float32 at the path's shape: kernel {f32_ms:.4f} ms,"
        f" bound {f32_bound:.4f} ms ({f32_by}, 67 TFLOP/s without TF32)")

    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:36",
        "launches": launches, "max_abs_err": path_err,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
