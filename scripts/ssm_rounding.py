#!/usr/bin/env python3
"""How far float32 rounding moves the ssm and hybrid families' grads, on
one device and sharded: the readings behind the rounding cases of
``tests/test_torch_distributed_ssm.py``.

On the CPU, for reduced rwkv6-3b and reduced zamba2-2.7b (4 layers, as the
test draws them) and each token seed, the port's loss and grads of
``lm_loss`` in float64 (``repro_torch.testing.precision``), from the
port's own draw of the params (seed 0), on one device and on 4 gloo ranks
on the meshes (data 2, model 2) and (data 1, model 4); then in float32 the
same.  It prints, for each seed, |g32 - g64| / |g64|
over all grads together for the single device and each mesh, the largest
element gap of any grad against float64 over the tests' allowance
(1e-4 + 1e-4 |g64|), and the sharded float64 grads' largest gap from the
single device's float64 grads.

    PYTHONPATH=src python scripts/ssm_rounding.py --seeds 0,1,2,3,4,5
"""

import argparse
import logging
import sys
import tempfile

import numpy as np
import torch

MESHES = ((2, 2), (1, 4))
ARCHS = {"rwkv6-3b": {}, "zamba2-2.7b": {"num_layers": 4}}
BATCH, SEQ = 4, 32


def _cfg(arch):
    from repro_torch import configs
    return configs.reduced(configs.get_config(arch), dtype="float32",
                           **ARCHS[arch])


def _batch(vocab: int, seed: int) -> dict:
    toks = np.random.default_rng(seed).integers(0, vocab, (BATCH, SEQ + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _grads(cfg, params, tokens, labels, ctx=None):
    from repro_torch.models.context import NULL_CTX
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.train.tree import flatten
    loss, grads = loss_and_grads(cfg, params, tokens, labels,
                                 ctx=ctx or NULL_CTX)
    if ctx is None:
        return {k: v.double().numpy() for k, v in flatten(grads)}
    return {k: v.full_tensor().double().numpy() for k, v in flatten(grads)}


def _rank(rank, world, arch, seeds):
    """Every seed's sharded grads on each mesh, float32 and float64."""
    from repro_torch import bridge
    from repro_torch.configs import RunConfig
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.transformer import init_lm
    from repro_torch.parallel.sharding import distribute_local, make_context
    from repro_torch.testing import gloo_cuda
    from repro_torch.testing.precision import float64_compute
    from repro_torch.train.tree import tree_map
    gloo_cuda.use_c10d_collectives()
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    cfg = _cfg(arch)
    out = {}
    for shape in MESHES:
        ctx = make_context(make_smoke_mesh(shape, device="cpu"), cfg,
                           RunConfig())
        for dtype in (torch.float32, torch.float64):
            params = bridge.place_params(tree_map(
                lambda x: x.to(dtype), init_lm(cfg, 0, device="cpu")),
                cfg, ctx.mesh)
            for seed in seeds:
                b = _batch(cfg.vocab_size, seed)
                tok, lab = (distribute_local(
                    torch.as_tensor(b[n]).long(), ctx.dmesh,
                    ctx.placements("dp", None)) for n in ("tokens",
                                                          "labels"))
                if dtype == torch.float64:
                    with float64_compute():
                        g = _grads(cfg, params, tok, lab, ctx)
                else:
                    g = _grads(cfg, params, tok, lab, ctx)
                out[(shape, str(dtype), seed)] = g
    return out if rank == 0 else None


def _rel(got, want) -> float:
    num = sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items())
    return (num / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5


def _over_allowance(got, want) -> float:
    return max(float((np.abs(got[k] - w) / (1e-4 + 1e-4 * np.abs(w))).max())
               for k, w in want.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3,4,5")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    from repro_torch.models.transformer import init_lm
    from repro_torch.testing import run_ranks
    from repro_torch.testing.precision import float64_compute
    from repro_torch.train.tree import tree_map
    for arch in ARCHS:
        cfg = _cfg(arch)
        with tempfile.TemporaryDirectory() as tmp:
            sharded = run_ranks(_rank, 4, (arch, seeds), workdir=tmp,
                                timeout=1200)[0]
        p32 = init_lm(cfg, 0, device="cpu")
        p64 = tree_map(lambda x: x.double(), p32)
        print(f"{arch} (reduced{', 4 layers' if ARCHS[arch] else ''}): "
              f"|g32 - g64| / |g64| and the worst element over the "
              f"allowance, single device then {MESHES}; sharded float64 "
              f"vs single float64, largest |gap|")
        for seed in seeds:
            b = _batch(cfg.vocab_size, seed)
            tok, lab = (torch.as_tensor(b[n]).long() for n in ("tokens",
                                                               "labels"))
            g32 = _grads(cfg, p32, tok, lab)
            with float64_compute():
                g64 = _grads(cfg, p64, tok, lab)
            runs = [g32] + [sharded[(m, str(torch.float32), seed)]
                            for m in MESHES]
            wide = max(float(np.abs(sharded[(m, str(torch.float64), seed)][k]
                                    - g64[k]).max())
                       for m in MESHES for k in g64)
            print(f"  seed {seed}: " + ", ".join(
                f"{_rel(g, g64):.3e} ({_over_allowance(g, g64):.2f})"
                for g in runs) + f"; float64 {wide:.3e}")
            sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
