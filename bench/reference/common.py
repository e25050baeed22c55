"""Pieces the references share: norms, RoPE, the matrix product (plain or
through an 8-bit float, the control), the loss, AdamW, and a loss and
gradients taken layer by layer."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..weights import nest

FP8_MAX = 448.0          # the largest finite float8_e4m3fn


def no_tf32() -> None:
    """Float32 products in float32: TF32 would round them to 10 bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Fp8(torch.autograd.Function):
    """x rounded through float8_e4m3fn at one scale for the tensor (its
    largest magnitude maps to 448); the gradient passes straight."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def make_ops(quant: Optional[str]) -> Callable:
    """The operand rounding of every product: None (float32) or "fp8"."""
    if quant is None:
        return lambda x: x
    if quant == "fp8":
        return fp8
    raise ValueError(f"unknown quantisation {quant!r}")


def rmsnorm(x, scale, eps=1e-5):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def layernorm(x, scale, bias, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def norm(kind: str, p: Dict, x):
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def rope(x, theta: float):
    """x (B, S, H, hd) at positions 0..S-1, split halves (not interleaved
    pairs)."""
    s, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                         device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] \
        * freqs
    cos = torch.cos(ang).to(x.dtype)[:, None, :]
    sin = torch.sin(ang).to(x.dtype)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def cross_entropy(logits, labels):
    """Mean next-token cross entropy."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


# ---------------------------------------------------------------------------
# AdamW, as the configuration states it
# ---------------------------------------------------------------------------

def lr_at(opt: Dict, step: int) -> float:
    """Linear warm-up to lr, then a cosine to min_lr_ratio x lr."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(opt["warmup_steps"], 1)
    prog = (step - opt["warmup_steps"]) / max(
        opt["total_steps"] - opt["warmup_steps"], 1)
    prog = min(max(prog, 0.0), 1.0)
    r = opt["min_lr_ratio"]
    return opt["lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
          m: Dict, v: Dict, step: int, opt: Dict) -> None:
    """One AdamW step in place over flat dicts by path: the gradients
    clipped to a global norm of ``clip_norm``, bias-corrected moments, and
    decoupled weight decay on every leaf of two or more dims as the tree
    holds it (stacked layer leaves included)."""
    gnorm = math.sqrt(sum(float(g.double().square().sum())
                          for g in grads.values()))
    scale = min(opt["clip_norm"] / (gnorm + 1e-9), 1.0) \
        if opt["clip_norm"] > 0 else 1.0
    lr = lr_at(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    for path, p in params.items():
        g = grads[path] * scale
        m[path].mul_(b1).add_(g, alpha=1 - b1)
        v[path].mul_(b2).addcmul_(g, g, value=1 - b2)
        u = (m[path] / (1 - b1 ** step)) / (
            torch.sqrt(v[path] / (1 - b2 ** step)) + opt["eps"])
        if p.dim() >= 2:
            u = u + opt["weight_decay"] * p
        p.sub_(lr * u)


# ---------------------------------------------------------------------------
# loss and gradients of a stacked model, layer by layer
# ---------------------------------------------------------------------------

def layer_slice(flat: Dict[str, torch.Tensor], i: int) -> Dict[str, object]:
    """Layer ``i``'s leaves (paths under ``layers/``, the prefix dropped),
    each a detached view that takes a gradient of its own."""
    out = {}
    for path, t in flat.items():
        if path.startswith("layers/"):
            out[path[len("layers/"):]] = t[i].detach().requires_grad_()
    return out


def loss_and_grads(flat: Dict[str, torch.Tensor], tokens, labels, *,
                   num_layers: int, layer: Callable, head: Callable):
    """(loss, grads by path) of a stacked model: the forward keeps only each
    layer's input, and the backward recomputes one layer at a time, so the
    graph of one layer is alive at once.  ``layer(p, x) -> x`` takes a
    nested dict of one layer's leaves; ``head(top, x) -> loss`` the
    top-level leaves but the embedding."""
    with torch.no_grad():
        x = flat["embed"][tokens]
        inputs: List[torch.Tensor] = []
        for i in range(num_layers):
            inputs.append(x)
            x = layer(nest(layer_slice(flat, i)), x)
    top = {p: t.detach().requires_grad_() for p, t in flat.items()
           if not p.startswith("layers/") and p != "embed"}
    x = x.detach().requires_grad_()
    loss = head(nest(top), x)
    got = torch.autograd.grad(loss, [x, *top.values()])
    gx = got[0]
    grads = dict(zip(top, got[1:]))
    for path, t in flat.items():
        if path.startswith("layers/"):
            grads[path] = torch.zeros_like(t)
    for i in reversed(range(num_layers)):
        xi = inputs[i].requires_grad_()
        lp = layer_slice(flat, i)
        y = layer(nest(lp), xi)
        got = torch.autograd.grad(y, [xi, *lp.values()], gx)
        gx = got[0]
        for name, g in zip(lp, got[1:]):
            grads["layers/" + name][i] = g
        inputs[i] = None
        del y, got
    grads["embed"] = torch.zeros_like(flat["embed"]).index_add_(
        0, tokens.reshape(-1), gx.reshape(-1, gx.shape[-1]))
    return loss.detach(), grads
