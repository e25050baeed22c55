#!/usr/bin/env python3
"""How far bf16 compute moves zamba2-2.7b's first-step grads from float32's
on the card, on one rank and on ranks sharing it: the readings behind
``chip_smoke.py``'s float32 gate for phase 4h step (6).

Phase 4h (6)'s configuration (``chip_smoke.ssm_cfg``: full width, cut to
12 layers, 4 x 1024, remat full, chunk 16, float32 masters drawn from seed
0).  On one rank with no mesh, for each of ``--batches``: loss and grads in
float32 and in bf16 compute, and each grad's norm and its gap from
float32's.  Then, on batch 0, bf16 grads on 4 gloo ranks sharing cuda:0
for each of ``--meshes`` (data x model), each grad's gap from the single
rank's float32 and bf16 grads.  Prints one line a run and writes every
grad's numbers to ``--out`` (JSON).  Needs one card.

    python3 scripts/zamba2_bf16_noise.py --out reports/bf16_noise.json
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ARCH = "zamba2-2.7b"


def _norms(grads, ref) -> dict:
    """{leaf: [|g|, |g - ref|]} in float64."""
    return {k: [float(g.double().norm()), float((g.double()
                                                 - ref[k].double()).norm())]
            for k, g in grads.items()}


def _total(rows: dict, i: int) -> float:
    return sum(v[i] ** 2 for v in rows.values()) ** 0.5


def single_rank(batches, saved: Path) -> dict:
    """Float32 and bf16 grads on one rank for each batch; batch 0's saved
    to ``saved`` for the ranks."""
    import torch
    import chip_smoke as cs
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.models.context import ModelContext
    from repro_torch.models.transformer import init_lm
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.train.tree import flatten
    dev = torch.device("cuda", 0)
    cfg = cs.ssm_cfg(ARCH)
    ctx = ModelContext(remat=cs.SSM_REMAT, ssm_chunk=cs.SSM_CHUNK)
    params = init_lm(cfg, 0, device=dev)
    source = SyntheticSource(DataConfig(cfg.vocab_size, cs.SSM_SEQ,
                                        cs.SSM_BATCH))
    out = {}
    for batch in batches:
        data = source.batch(batch)
        toks, labels = (torch.as_tensor(data[n]).to(dev, torch.long)
                        for n in ("tokens", "labels"))
        grads, losses = {}, {}
        for dtype in ("float32", "bfloat16"):
            loss, g = loss_and_grads(dataclasses.replace(cfg, dtype=dtype),
                                     params, toks, labels, ctx=ctx)
            grads[dtype], losses[dtype] = dict(flatten(g)), loss.item()
        rows = _norms(grads["bfloat16"], grads["float32"])
        n32 = _total(_norms(grads["float32"], grads["float32"]), 0)
        out[batch] = {"loss": losses, "norm_float32": n32,
                      "norm_bfloat16": _total(rows, 0),
                      "gap": _total(rows, 1), "leaves": rows}
        print(f"single rank, batch {batch}: loss float32 "
              f"{losses['float32']:.6f} bf16 {losses['bfloat16']:.6f}; "
              f"grad norm float32 {n32:.6f} bf16 {_total(rows, 0):.6f} "
              f"(relative gap {abs(_total(rows, 0) - n32) / n32:.4e}); "
              f"|g_bf16 - g_f32| / |g_f32| {_total(rows, 1) / n32:.4f}",
              flush=True)
        if batch == 0:
            for dtype, g in grads.items():
                torch.save({k: v.cpu() for k, v in g.items()},
                           saved / f"{dtype}.pt")
        del grads
    del params
    torch.cuda.empty_cache()
    return out


def sharded_rank(rank: int, world: int, shape, saved: str) -> dict:
    """Batch 0's bf16 grads on a (data, model) mesh; rank 0 holds each grad
    against the single rank's saved float32 and bf16 grads."""
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch.bridge import init_sharded
    from repro_torch.configs import RunConfig
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.parallel.sharding import distribute_local, make_context
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.train.tree import flatten
    cs.dist_rank_device()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(cs.ssm_cfg(ARCH), dtype="bfloat16")
    ctx = make_context(make_smoke_mesh(shape, device="cuda"), cfg,
                       RunConfig(remat=cs.SSM_REMAT, sequence_parallel=False,
                                 ssm_chunk=cs.SSM_CHUNK))
    params = init_sharded(cfg, ctx.mesh, seed=0)
    data = cs.first_batch(cfg, cs.SSM_BATCH, cs.SSM_SEQ)
    toks, labels = (distribute_local(
        torch.as_tensor(data[n]).to(dev, torch.long), ctx.dmesh,
        ctx.placements("dp", None)) for n in ("tokens", "labels"))
    loss, grads = loss_and_grads(cfg, params, toks, labels, ctx=ctx)
    loss = loss.full_tensor().item()
    del params
    refs = ({d: torch.load(Path(saved) / f"{d}.pt", mmap=True)
             for d in ("float32", "bfloat16")} if rank == 0 else None)
    rows = {}
    for k, g in flatten(grads):
        full = g.full_tensor()
        if rank == 0:
            a = full.double()
            rows[k] = [float(a.norm())] + [
                float((a - refs[d][k].to(dev).double()).norm())
                for d in ("float32", "bfloat16")]
        del full
    dist.barrier()
    if rank:
        return None
    return {"loss": loss, "view": list(ctx.mesh.mesh.shape), "leaves": rows,
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="0,1,2,3")
    ap.add_argument("--meshes", default="2x2,4x1,1x4")
    ap.add_argument("--out", default="reports/bf16_noise.json")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.testing import run_ranks
    if not torch.cuda.is_available():
        print("zamba2_bf16_noise: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        saved = Path(tmp)
        out["single"] = single_rank(
            [int(b) for b in args.batches.split(",")], saved)
        n32 = out["single"][0]["norm_float32"]
        n16 = out["single"][0]["norm_bfloat16"]
        for mesh in args.meshes.split(","):
            shape = tuple(int(x) for x in mesh.split("x"))
            t0 = time.perf_counter()
            r = run_ranks(sharded_rank, 4, (shape, str(saved)),
                          workdir=saved / "ranks", timeout=900)[0]
            out[mesh] = r
            norm = _total(r["leaves"], 0)
            print(f"sharded bf16 on {mesh} (view {r['view']}), batch 0: "
                  f"loss {r['loss']:.6f}, grad norm {norm:.6f} (relative "
                  f"gap {abs(norm - n16) / n16:.4e} from the single rank's "
                  f"bf16, {abs(norm - n32) / n32:.4e} from its float32); "
                  f"|g - g_f32| / |g_f32| {_total(r['leaves'], 1) / n32:.4f}"
                  f", |g - g_bf16| / |g_f32| "
                  f"{_total(r['leaves'], 2) / n32:.4f}; peak "
                  f"{r['peak_gb']:.2f} GiB a rank; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
