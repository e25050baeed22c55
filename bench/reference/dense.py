"""Plain reference of a dense decoder (phi3-mini's backbone): pre-norm
blocks of grouped-query causal attention with RoPE and a gated SiLU MLP,
RMSNorm, an untied head.

Equations: h = norm1(x); q, k, v = h Wq, h Wk, h Wv split into heads; q, k
rotated (split halves, θ = rope_theta); o = softmax(q kᵀ / √hd + causal
mask) v, query head i reading key head i // (Hq / Hkv); x += o Wo;
h = norm2(x); x += (silu(h Wgate) ⊙ h Wup) Wdown.  Logits = norm_f(x)
Whead.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from .. import counts, weights
from . import common

# a dense decoder, and the vlm family's decoder on tokens alone
FAMILIES = ("dense", "vlm")
FLOAT32_LEAVES = ()


def layer_leaves(cfg: Dict) -> List:
    """A block's attention and MLP leaves, stacked over the layers."""
    d, f, L = cfg["d_model"], cfg["d_ff"], (cfg["num_layers"],)
    hd, hq, hkv = cfg["head_dim"], cfg["num_heads"], cfg["num_kv_heads"]
    out = [weights.matrix("layers/attn/wq", L, d, hq * hd),
           weights.matrix("layers/attn/wk", L, d, hkv * hd),
           weights.matrix("layers/attn/wv", L, d, hkv * hd),
           weights.matrix("layers/attn/wo", L, hq * hd, d),
           weights.matrix("layers/mlp/w_up", L, d, f),
           weights.matrix("layers/mlp/w_down", L, f, d)]
    if cfg["act"] == "silu":
        out.append(weights.matrix("layers/mlp/w_gate", L, d, f))
    return out


def layer_matrices(cfg: Dict) -> int:
    """Weights that enter matrix products, over all layers."""
    d, f, hd = cfg["d_model"], cfg["d_ff"], cfg["head_dim"]
    mlp = 3 * d * f if cfg["act"] == "silu" else 2 * d * f
    return cfg["num_layers"] * (2 * d * cfg["num_heads"] * hd
                                + 2 * d * cfg["num_kv_heads"] * hd + mlp)


def mixer_fwd_flops(cfg: Dict, batch: int, seq: int, chunk: int = 0) -> int:
    """Causal attention's forward over its live pairs, all layers."""
    return cfg["num_layers"] * counts.attn_fwd_flops(
        batch, seq, seq, cfg["num_heads"], cfg["head_dim"])


def attention(q, k, v, mm):
    """q (B, S, Hq, hd), k / v (B, S, Hkv, hd) -> (B, S, Hq, hd), causal."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = mm(q).reshape(b, s, hkv, hq // hkv, hd).permute(0, 2, 3, 1, 4)
    kt = mm(k).permute(0, 2, 3, 1)[:, :, None]             # (B,Hkv,1,hd,S)
    scores = (qg @ kt) / math.sqrt(hd)                      # (B,Hkv,G,S,S)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = mm(p) @ mm(v).permute(0, 2, 1, 3)[:, :, None]       # (B,Hkv,G,S,hd)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd)


def layer(cfg: Dict, p: Dict, x, mm, kv: Optional[List] = None):
    b, s, _ = x.shape
    hq, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    a = p["attn"]
    h = common.norm(cfg["norm"], p["ln1"], x)
    h = mm(h)
    q = (h @ mm(a["wq"])).reshape(b, s, hq, hd)
    k = (h @ mm(a["wk"])).reshape(b, s, hkv, hd)
    v = (h @ mm(a["wv"])).reshape(b, s, hkv, hd)
    q, k = common.rope(q, cfg["rope_theta"]), common.rope(k, cfg["rope_theta"])
    if kv is not None:
        kv.append((k, v))
    o = attention(q, k, v, mm).reshape(b, s, hq * hd)
    x = x + mm(o) @ mm(a["wo"])
    h = mm(common.norm(cfg["norm"], p["ln2"], x))
    f = p["mlp"]
    up = h @ mm(f["w_up"])
    gate = h @ mm(f["w_gate"]) if "w_gate" in f else None
    act = (torch.nn.functional.silu(gate) * up if gate is not None
           else torch.nn.functional.gelu(up, approximate="tanh"))
    return x + mm(act) @ mm(f["w_down"])


def logits(cfg: Dict, top: Dict, x, mm):
    return mm(common.norm(cfg["norm"], top["ln_f"], x)) @ mm(top["lm_head"])


def loss_and_grads(cfg: Dict, flat: Dict[str, torch.Tensor], tokens, labels,
                   quant: Optional[str] = None):
    mm = common.make_ops(quant)
    return common.loss_and_grads(
        flat, tokens, labels, num_layers=cfg["num_layers"],
        layer=lambda p, x: layer(cfg, p, x, mm),
        head=lambda top, x: common.cross_entropy(logits(cfg, top, x, mm),
                                                 labels))


@torch.no_grad()
def prefill(cfg: Dict, flat: Dict[str, torch.Tensor], tokens,
            quant: Optional[str] = None
            ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """tokens (1, S) -> (the last position's logits (V,), each layer's
    rotated k and v (S, Hkv, hd)), in float32."""
    mm = common.make_ops(quant)
    x = flat["embed"].float()[tokens]
    kv: List = []
    for i in range(cfg["num_layers"]):
        p = common.nest({path[len("layers/"):]: t[i].float()
                         for path, t in flat.items()
                         if path.startswith("layers/")})
        x = layer(cfg, p, x, mm, kv)
    top = common.nest({p: t.float() for p, t in flat.items()
                       if not p.startswith("layers/")})
    out = logits(cfg, top, x[:, -1:], mm)
    return out[0, 0], [(k[0], v[0]) for k, v in kv]
