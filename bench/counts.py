"""Operations and bytes of the benchmark's work, counted from shapes.

The yardstick of every roofline share and ``mfu`` metric.  It imports
nothing of the program: the work is what the model needs, the same
whatever implements it.  Inputs are read once and outputs written once,
and recomputed work is never counted.

Configurations are the dicts of ``bench/configs/<name>.json``; what is
particular to a family (its block's matrices, its sequence mixer) is
counted by the reference module the configuration names.
"""

from __future__ import annotations

from . import reference

# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): bf16 / fp16 on the tensor cores, TF32 on the tensor cores,
# float32 outside them, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def live_pairs(sq: int, skv: int, causal: bool, window=None) -> int:
    """The (q, k) pairs the masks leave: query row i sees keys
    [max(0, i - window + 1), min(skv, i + 1)) when causal, all skv
    otherwise."""
    if not window:
        if not causal:
            return sq * skv
        n = min(sq, skv)
        return n * (n + 1) // 2 + (sq - n) * skv
    total = 0
    for i in range(sq):
        hi = min(skv, i + 1) if causal else skv
        lo = max(0, i - window + 1) if window else 0
        total += max(hi - lo, 0)
    return total


def least_seconds(nbytes: float, **flops_at_rate: float) -> float:
    """Least time on the card: the larger of the bytes at the memory rate
    and the operations, each kind at its own peak (``bf16``, ``tf32x3``:
    float32 products as three TF32 products, ``f32``), summed."""
    rates = {"bf16": PEAK_BF16_FLOPS, "tf32x3": PEAK_TF32_FLOPS / 3,
             "f32": PEAK_F32_FLOPS}
    t_ops = sum(f / rates[k] for k, f in flops_at_rate.items())
    return max(t_ops, nbytes / PEAK_BYTES)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_fwd_flops(b, sq, skv, hq, hd, causal=True, window=None) -> int:
    """QKᵀ and PV over the live pairs, a multiply and an add each."""
    return 4 * b * hq * hd * live_pairs(sq, skv, causal, window)


def attn_fwd_bytes(b, sq, skv, hq, hkv, hd, esize) -> int:
    """q, k, v read and o written once."""
    return esize * (2 * b * sq * hq * hd + 2 * b * skv * hkv * hd)


def attn_bwd_flops(b, sq, skv, hq, hd, causal=True, window=None) -> int:
    """The backward's four products (dV = PᵀdO, dP = dO Vᵀ, dQ = dS K,
    dK = dSᵀQ): twice the forward's two; the recompute of S is not
    counted."""
    return 2 * attn_fwd_flops(b, sq, skv, hq, hd, causal, window)


def attn_bwd_bytes(b, sq, skv, hq, hkv, hd, esize) -> int:
    """q, k, v, o and dO read, dq, dk and dv written once."""
    return esize * (4 * b * sq * hq * hd + 4 * b * skv * hkv * hd)


# ---------------------------------------------------------------------------
# the chunked recurrence (rwkv6's time mix)
# ---------------------------------------------------------------------------

def rwkv6_fwd_work(bh, t, dk, dv, chunk, heads, esize, exclusive=True):
    """(products, other float32 operations, bytes) of one forward call at
    ``chunk``.  Per chunk: the live score pairs times K and V, the
    cross-chunk read and the state update (C·K·V multiply-adds each); the
    decay scaling of S and, per row with the bonus, Σ_k q·u·k and its
    product with v.  Bytes: q, k, v and the log decay read and the output
    written once in their dtype, the final S written in float32, the bonus
    (heads, K) read in float32."""
    nc = t // chunk
    pairs = chunk * (chunk - 1) // 2 if exclusive else chunk * (chunk + 1) // 2
    products = bh * nc * (2 * pairs * (dk + dv) + 4 * chunk * dk * dv)
    other = bh * nc * dk * dv + (bh * t * (3 * dk + 2 * dv) if exclusive
                                 else 0)
    nbytes = (bh * (esize * (3 * t * dk + 2 * t * dv) + 4 * dk * dv)
              + (4 * heads * dk if exclusive else 0))
    return products, other, nbytes


def rwkv6_fwd_seconds(bh, t, dk, dv, chunk, heads, esize) -> float:
    products, other, nbytes = rwkv6_fwd_work(bh, t, dk, dv, chunk, heads,
                                             esize)
    return least_seconds(nbytes, tf32x3=products, f32=other)


def rwkv6_bwd_seconds(bh, t, dk, dv, chunk, heads, esize) -> float:
    """The grads of one call: every forward product gives two (one for each
    operand) and so does the elementwise work; bytes: q, k, v, the log
    decay and dO read, dq, dk, dv and the log decay's grad written in their
    dtype, the final state's grad read in float32, the bonus read and its
    grad written in float32.  The recompute is not counted."""
    products, other, _ = rwkv6_fwd_work(bh, t, dk, dv, chunk, heads, esize)
    nbytes = (bh * (esize * (5 * t * dk + 4 * t * dv) + 4 * dk * dv)
              + 2 * 4 * heads * dk)
    return least_seconds(nbytes, tf32x3=2 * products, f32=2 * other)


def rwkv6_scan_flops(bh, t, dk, dv, chunk) -> int:
    """The recurrence's products at ``chunk`` in the model's FLOP count:
    per (B, H) T·(2c·(K + V) + 4·K·V)."""
    return bh * t * (2 * chunk * (dk + dv) + 4 * dk * dv)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def adamw_bytes(n_params: int) -> int:
    """Float32 p, g, m and v read and p, m and v written once."""
    return 7 * 4 * n_params


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def layer_matrices(cfg: dict) -> int:
    """Weights that enter matrix products, over all layers, as the
    configuration's reference module counts them."""
    return reference.module(cfg).layer_matrices(cfg)


def mixer_fwd_flops(cfg: dict, batch: int, seq: int, chunk: int = 0) -> int:
    """The sequence mixer's forward over all layers (attention's live
    causal pairs, or the recurrence at ``chunk``), as the configuration's
    reference module counts it."""
    return reference.module(cfg).mixer_fwd_flops(cfg, batch, seq, chunk)


def train_step_flops(cfg: dict, batch: int, seq: int, chunk: int = 0) -> int:
    """Model FLOPs of one training step: 6 x (layer matrices + head) x
    tokens, plus the mixer's forward and its backward (twice the forward);
    recompute not counted."""
    head = cfg["d_model"] * cfg["vocab_size"]
    return (6 * (layer_matrices(cfg) + head) * batch * seq
            + 3 * mixer_fwd_flops(cfg, batch, seq, chunk))


def prefill_flops(cfg: dict, prompt: int, chunk: int = 0) -> int:
    """Model FLOPs of one prefill of one prompt: the layer matrices over
    every prompt token, the mixer's forward, the head at the last
    position, the only one prefill computes logits for."""
    return (2 * layer_matrices(cfg) * prompt
            + mixer_fwd_flops(cfg, 1, prompt, chunk)
            + 2 * cfg["d_model"] * cfg["vocab_size"])


def param_count(cfg: dict) -> int:
    """Parameters of the trained tree (``bench.weights.leaf_specs``)."""
    from .weights import leaf_specs
    total = 0
    for _, shape, _ in leaf_specs(cfg):
        n = 1
        for s in shape:
            n *= s
        total += n
    return total
