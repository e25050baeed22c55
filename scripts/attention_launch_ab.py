#!/usr/bin/env python3
"""Small attention calls timed for two trees in turns, beside the host's
launch time a call.

Times the attention kernel at whisper-base's cross shape (B 16, Sq 224,
Skv 1500, 8 / 8 heads of 64, non-causal), its encoder's (1500 x 1500) and
tinyllama-1.1b's (B 4, S 2048, 32 / 4 heads of 64, causal), bf16, for the
``repro_torch`` of each tree in its own process, in turns (A, B, B, A).
Each shape: 3 warm-up calls, then the median of 5 runs of 20 calls, timed
with CUDA events ("events_ms") and on the host clock from the first launch
to the last, before the synchronize ("host_launch_ms"): where the two
agree, the host's launch rate, not the kernel, sets the shape's time.
Prints the card's name and power limit, then one JSON row a turn.  Needs
one card and nvcc.

    python3 scripts/attention_launch_ab.py PARENT_TREE .
"""
import subprocess
import sys

CHILD = r'''
import sys, time, json
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
build.BUILD_DIR = __import__("pathlib").Path(sys.argv[1]) / "build" / "kernels"
build.build_all(["flash_attention"])
dev = torch.device("cuda"); gen = torch.Generator(device=dev).manual_seed(0)
out = {}
for name, (b, sq, skv, hq, hkv, hd, causal) in {
        "whisper-cross": (16, 224, 1500, 8, 8, 64, False),
        "whisper-encoder": (16, 1500, 1500, 8, 8, 64, False),
        "tinyllama": (4, 2048, 2048, 32, 4, 64, True)}.items():
    q = torch.randn((b, sq, hq, hd), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, skv, hkv, hd), generator=gen, device=dev).bfloat16() for _ in range(2))
    f = lambda: fa.flash_attention(q, k, v, causal=causal)
    for _ in range(3): f()
    torch.cuda.synchronize()
    ev, host = [], []
    for _ in range(5):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter(); s.record()
        for _ in range(20): f()
        e.record(); h = (time.perf_counter() - t) / 20; torch.cuda.synchronize()
        ev.append(s.elapsed_time(e) / 20); host.append(h * 1e3)
    out[name] = {"events_ms": sorted(ev)[2], "host_launch_ms": sorted(host)[2]}
print(json.dumps(out))
'''


def main() -> None:
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    a, b = sys.argv[1:]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for tree in (a, b, b, a):
        r = subprocess.run([sys.executable, "-c", CHILD, tree],
                           capture_output=True, text=True)
        print(tree, r.stdout.strip() or r.stderr[-2000:])


if __name__ == "__main__":
    main()
