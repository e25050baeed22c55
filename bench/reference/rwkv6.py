"""Plain reference of RWKV6 ("Finch", arXiv:2404.05892) as the
configuration states it: the block the program runs, which departs from
the published one as the configuration's ``assumed`` lists (w_o a channel
scale, a static token shift, ln_x over all channels, no receptance gate in
the channel mix).

A block: x += time_mix(LN1(x)); x += channel_mix(LN2(x)).

Time mix, with x₋ the previous position's input (zeros at the first):
xᵢ = x + (x₋ − x) ⊙ μᵢ for i in r, k, v, g, w; r, k, v = xᵣWr, xₖWk, xᵥWv;
g = silu(x_g Wg); the log decay w = −exp(base + tanh(x_w A) B), clamped to
[−4, 0] per step; per head (K = V = head size) the state
S_t = diag(exp(w_t)) S_{t−1} + k_t v_tᵀ from S = 0 and the output
o_t = r_tᵀ S_{t−1} + (Σ_k r_t,k u_k k_t,k) v_t (u the bonus); then
y = LN_x(o) ⊙ g, each channel scaled by the row sum of W_o.

Channel mix: x_k = x + (x₋ − x) ⊙ μ; y = relu(x_k W_k)² W_v.

The recurrence is taken in chunks of ``ssm_chunk`` positions: within a
chunk the products of the decays are exponentials of cumulative sums
(centred per chunk and channel), and the state runs from chunk to chunk.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .. import counts, weights
from . import common

FAMILIES = ("ssm",)
# read in float32 whatever the served dtype is
FLOAT32_LEAVES = ("decay_base", "bonus_u")
LOG_DECAY_MIN = -4.0


def layer_leaves(cfg: Dict) -> List:
    """A block's time-mix and channel-mix leaves, stacked over the
    layers."""
    d, f, L = cfg["d_model"], cfg["d_ff"], (cfg["num_layers"],)
    hd, rank = cfg["rwkv_head_dim"], cfg["rwkv_decay_rank"]
    out = [weights.matrix(f"layers/tmix/w_{n}", L, d, d) for n in "rkvgo"]
    out += [weights.matrix("layers/tmix/w_decay_a", L, d, rank),
            weights.matrix("layers/tmix/w_decay_b", L, rank, d),
            ("layers/tmix/decay_base", (*L, d), ("const", -0.5)),
            ("layers/tmix/bonus_u", (*L, d // hd, hd), ("normal", 0.1)),
            ("layers/tmix/mix_x", (*L, 5, d), ("const", 0.5))]
    out += weights.norm_leaves("layers/tmix/ln_x", "layernorm", L, d)
    return out + [weights.matrix("layers/cmix/w_k", L, d, f),
                  weights.matrix("layers/cmix/w_v", L, f, d),
                  ("layers/cmix/mix", (*L, d), ("const", 0.5))]


def layer_matrices(cfg: Dict) -> int:
    """Weights that enter matrix products, over all layers: r, k, v, g,
    the low-rank decay and the channel mix.  w_o only scales channels by
    its row sums, so it is read, not multiplied."""
    d, f = cfg["d_model"], cfg["d_ff"]
    return cfg["num_layers"] * (4 * d * d + 2 * d * cfg["rwkv_decay_rank"]
                                + 2 * d * f)


def mixer_fwd_flops(cfg: Dict, batch: int, seq: int, chunk: int = 0) -> int:
    """The recurrence's products at ``chunk``, all layers."""
    hd = cfg["rwkv_head_dim"]
    return cfg["num_layers"] * counts.rwkv6_scan_flops(
        batch * (cfg["d_model"] // hd), seq, hd, hd, chunk)


def shift(x):
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def recurrence(r, k, v, w, u, chunk: int, mm):
    """r, k, w (B, H, T, K), v (B, H, T, V), u (H, K) -> o (B, H, T, V)."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    nc = t // chunk
    w = w.clamp(LOG_DECAY_MIN, 0.0).reshape(b, h, nc, chunk, dk)
    rc, kc = mm(r).reshape(b, h, nc, chunk, dk), mm(k).reshape(b, h, nc,
                                                               chunk, dk)
    vc = mm(v).reshape(b, h, nc, chunk, dv)
    L = w.cumsum(dim=3)                      # decay through position j
    Lr = L - w                               # through j - 1: what r_j reads
    Lc = L[:, :, :, -1:]
    c = 0.5 * (Lr.amax(dim=3, keepdim=True) + L.amin(dim=3, keepdim=True))
    strict = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=r.device).tril(-1)
    scores = (rc * torch.exp(Lr - c)) @ (kc * torch.exp(c - L)).transpose(
        -1, -2)
    intra = scores.masked_fill(~strict, 0.0) @ vc
    k_out = kc * torch.exp(Lc - L)
    decay = torch.exp(Lc).transpose(-1, -2)  # (B, H, nc, K, 1)
    S = torch.zeros((b, h, dk, dv), dtype=r.dtype, device=r.device)
    starts = []
    for i in range(nc):
        starts.append(S)
        S = decay[:, :, i] * S + k_out[:, :, i].transpose(-1, -2) @ vc[:, :, i]
    inter = (rc * torch.exp(Lr)) @ torch.stack(starts, dim=2)
    bonus = (rc * u[None, :, None, None, :] * kc).sum(-1, keepdim=True) * vc
    return (intra + inter + bonus).reshape(b, h, t, dv)


def time_mix(cfg: Dict, p: Dict, x, mm):
    b, t, d = x.shape
    hd = cfg["rwkv_head_dim"]
    heads = d // hd
    mix = p["mix_x"]
    last = shift(x)
    xs = [mm(x + (last - x) * mix[i]) for i in range(5)]
    r, k, v = (xs[i] @ mm(p[n]) for i, n in enumerate(("w_r", "w_k", "w_v")))
    g = F.silu(xs[3] @ mm(p["w_g"]))
    low = torch.tanh(xs[4] @ mm(p["w_decay_a"]))
    w = -torch.exp(p["decay_base"] + mm(low) @ mm(p["w_decay_b"]))

    def heads_of(y):
        return y.reshape(b, t, heads, hd).transpose(1, 2)

    o = recurrence(*map(heads_of, (r, k, v, w)), p["bonus_u"],
                   cfg["train"]["ssm_chunk"], mm)
    y = o.transpose(1, 2).reshape(b, t, d)
    y = common.layernorm(y, p["ln_x"]["scale"], p["ln_x"]["bias"]) * g
    return y * p["w_o"].sum(dim=-1)


def channel_mix(p: Dict, x, mm):
    xk = mm(x + (shift(x) - x) * p["mix"])
    return mm(F.relu(xk @ mm(p["w_k"])).square()) @ mm(p["w_v"])


def layer(cfg: Dict, p: Dict, x, mm):
    x = x + time_mix(cfg, p["tmix"], common.norm(cfg["norm"], p["ln1"], x),
                     mm)
    return x + channel_mix(p["cmix"], common.norm(cfg["norm"], p["ln2"], x),
                           mm)


def loss_and_grads(cfg: Dict, flat: Dict[str, torch.Tensor], tokens, labels,
                   quant: Optional[str] = None):
    mm = common.make_ops(quant)

    def head(top, x):
        h = mm(common.norm(cfg["norm"], top["ln_f"], x))
        return common.cross_entropy(h @ mm(top["lm_head"]), labels)

    return common.loss_and_grads(
        flat, tokens, labels, num_layers=cfg["num_layers"],
        layer=lambda p, x: layer(cfg, p, x, mm), head=head)
