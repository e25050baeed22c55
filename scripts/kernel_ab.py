#!/usr/bin/env python3
"""The served kernels of two trees timed against each other on one card.

Times the attention kernel at every served path's shape (tinyllama,
deepseek, zamba2, phi-3, nemotron's heads, whisper's encoder, float32 at
tinyllama's) and the recurrence kernel at rwkv6-3b's and zamba2's Mamba2
serving shapes (chunk 16), each with CUDA events (20 launches after a
warm-up, the median of 5 such runs), for the ``repro_torch`` of each tree
given.  Each tree runs in its own process, in turns (A, B, B, A; with
more trees, each in order and then in reverse), and builds its kernels
into its own ``build/kernels``.  Prints one JSON object
of ms by tree, turn and shape, and the card's name and power limit.
Needs one card and nvcc.

    python3 scripts/kernel_ab.py PARENT_TREE . [MORE_TREES ...]

With ``--child`` it times the ``repro_torch`` on ``sys.path`` once and
prints its row (what each turn runs).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

# (B, Sq, Hq, Hkv, hd[, Skv]), causal, dtype
ATTENTION = {
    "tinyllama": ((4, 2048, 32, 4, 64), True, "bfloat16"),
    "deepseek": ((4, 2048, 16, 16, 128), True, "bfloat16"),
    "zamba2": ((4, 2048, 32, 32, 80), True, "bfloat16"),
    "phi-3": ((4, 2048, 32, 32, 96), True, "bfloat16"),
    "nemotron-heads": ((1, 2048, 96, 8, 192), True, "bfloat16"),
    "whisper-encoder": ((16, 1500, 8, 8, 64, 1500), False, "bfloat16"),
    "tinyllama-f32": ((4, 2048, 32, 4, 64), True, "float32"),
}
# (B, H, T, K, V), chunk 16
RWKV6_3B = (4, 40, 2048, 64, 64)
MAMBA2 = (4, 40, 2048, 64, 128)


def median_ms(fn, runs: int = 5, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[runs // 2]


def child() -> None:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6 as kr
    build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    row = {}
    for name, (shape, causal, dtype) in ATTENTION.items():
        b, sq, hq, hkv, hd = shape[:5]
        skv = shape[5] if len(shape) > 5 else sq
        q, k, v = (torch.randn((b, n, h, hd), generator=gen, device=dev)
                   .to(getattr(torch, dtype))
                   for n, h in ((sq, hq), (skv, hkv), (skv, hkv)))
        row[name] = median_ms(lambda: fa.flash_attention(q, k, v,
                                                         causal=causal))
    b, h, t, dk, dv = RWKV6_3B
    flat = [torch.randn((b, t, h * d), generator=gen, device=dev)
            for d in (dk, dk, dv, dk)]
    flat[3] = -torch.exp(flat[3] - 0.5)
    q, k, v, ld = (x.to(torch.bfloat16).view(b, t, h, -1).transpose(1, 2)
                   for x in flat)
    u = torch.randn((h, dk), generator=gen, device=dev) * 0.1
    row["rwkv6-3b"] = median_ms(lambda: kr.rwkv6_fused(q, k, v, ld, bonus=u,
                                                       chunk=16))
    b, h, t, dk, dv = MAMBA2
    c = torch.randn((b, t, dk), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((b, t, h), generator=gen,
                                                  device=dev))
    q = c[:, None].expand(b, h, t, dk)
    k = torch.randn((b, t, dk), generator=gen, device=dev)[:, None] \
        * dt.transpose(1, 2)[..., None]
    v = torch.randn((b, t, h * dv), generator=gen, device=dev).view(
        b, t, h, dv).transpose(1, 2)
    ld = (-dt).transpose(1, 2)[..., None].expand(b, h, t, dk).contiguous()
    row["mamba2"] = median_ms(lambda: kr.rwkv6_fused(q, k, v, ld, chunk=16))
    print(json.dumps(row), flush=True)


def main(trees) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    turns = list(trees) + list(trees)[::-1]
    out = {"card": smi, "turns": []}
    for tree in turns:
        root = Path(tree).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--child"], env=env, cwd=root,
                             capture_output=True, text=True, check=True)
        out["turns"].append({"tree": str(tree),
                             "ms": json.loads(run.stdout.splitlines()[-1])})
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
    else:
        main(sys.argv[1:])
