#!/usr/bin/env python3
"""The attention kernel's O += P V width at head_dim 80 and 96, on the card.

``csrc/flash_attention.cu``'s wgmma kernel runs O += P V as one m64n80 /
m64n96 product a k16 step (N = head_dim).  This script builds the source
as it is and a copy whose product runs at N = 128 over the zero-filled
columns of the second 64-column box (1.6x / 1.33x the PV products; the
accumulator grows to 64 registers and only head_dim columns are stored),
holds both against ``flash_attention_plain`` (one bf16 ulp) at zamba2-2.7b's
and phi-3-vision-4.2b's shapes, and times both with CUDA events in turns
(as is, n128, n128, as is).  Prints each build's ptxas registers and spills
for the wgmma instances and the card's name and power limit.  Needs one
card and nvcc.

    python3 scripts/attention_pv_width.py
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

OUT = ROOT / "build" / "pv_width"
SHAPES = {"zamba2-2.7b": (4, 2048, 32, 32, 80),
          "phi-3-vision-4.2b": (4, 2048, 32, 32, 96)}
# the source's PV product at N = head_dim -> at N = 64 x boxes
N128 = (("float (&o)[HD / 2], const uint32_t (&a_hi)",
         "float (&o)[32 * ((HD + 63) / 64)], const uint32_t (&a_hi)"),
        ("wgmma_rs<T, HD>(o, a_hi[kt], db);",
         "wgmma_rs<T, 64 * ((HD + 63) / 64)>(o, a_hi[kt], db);"),
        ("wgmma_rs<T, HD>(o, a_lo[kt], db);",
         "wgmma_rs<T, 64 * ((HD + 63) / 64)>(o, a_lo[kt], db);"),
        ("float o[HD / 2];", "float o[32 * P::NBOX];"),
        ("for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;",
         "for (int i = 0; i < 32 * P::NBOX; ++i) o[i] = 0.f;"),
        ("for (int i = 0; i < HD / 2; ++i) o[i] *= alpha",
         "for (int i = 0; i < 32 * P::NBOX; ++i) o[i] *= alpha"))


def compile_all() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    # the shared header inlined, so that both copies build outside csrc/ and
    # the PV product it holds is patched too
    text = (build.CSRC / "flash_attention.cu").read_text().replace(
        '#include "flash_attention.cuh"',
        (build.CSRC / "flash_attention.cuh").read_text()
        .replace("#pragma once\n", ""))
    variants = {"n=hd": text, "n128": text}
    for old, new in N128:
        if variants["n128"].count(old) != 1:
            sys.exit(f"the source no longer holds {old!r}")
        variants["n128"] = variants["n128"].replace(old, new)
    procs = {}
    for name, src in variants.items():
        path = OUT / f"{name.replace('=', '_')}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(path.with_suffix(".so")),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed on {name}:\n{out}")
        entry = None
        for line in out.splitlines():
            if "Compiling entry" in line:
                m = re.search(r"attn_fwd_wgmma_kernelI\d+(__nv_bfloat16|__half)"
                              r"Li(\d+)ELb([01])", line)
                entry = (f"{m[1].strip('_')} {m[2]}"
                         f"{' (hd = width)' if m[3] == '1' else ''}"
                         if m else None)
            elif entry and ("registers" in line or "spill" in line):
                print(f"{name} {entry}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name.replace('=', '_')}.so"))
    return libs


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = compile_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for arch, (b, s, hq, hkv, hd) in SHAPES.items():
        q, k, v = (torch.randn((b, s, h, hd), generator=gen, device=dev)
                   .to(torch.bfloat16) for h in (hq, hkv, hkv))
        ref = fa.flash_attention_plain(q, k, v).float()
        tol = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30)))
                         - 7).clamp_min(8e-3)
        times = {name: [] for name in libs}
        for name in ("n=hd", "n128", "n128", "n=hd"):
            build._libs["flash_attention"] = libs[name]
            err = (fa.flash_attention(q, k, v).float() - ref).abs()
            if not bool((err <= tol).all()):
                sys.exit(f"{arch} {name}: max_abs_err {err.max().item():.3e}")
            times[name].append(time_ms(lambda: fa.flash_attention(q, k, v)))
        print(f"{arch} (B {b}, S {s}, {hq} / {hkv} heads of {hd}, causal): "
              + ", ".join(f"{name} {' '.join(f'{t:.4f}' for t in ts)} ms"
                          for name, ts in times.items()))


if __name__ == "__main__":
    main()
