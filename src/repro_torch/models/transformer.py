"""Decoder-LM assembly, dense and ssm (RWKV6) families.

Same parameter layout as the reference (``repro/models/transformer.py``):
nested dicts with a stacked leading ``L`` axis on every layer leaf and
``(d_in, d_out)`` matrices, so ``bridge.params_from_numpy`` hands the
reference's own params to these functions.  The reference's ``lax.scan``
over ``L`` is a Python loop over the stacked axis here.

The dense family (slice 1 of the port) and the ssm family (slice 3) are
ported, for serving and, since slice 4, for training (``lm_loss`` on the
float32 master tree); the others raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import resolve_device
from .attention import attention_block, attn_init
from .common import (Params, compute_dtype, dense_init, embed_init,
                     norm_apply, norm_init)
from .context import NULL_CTX, ModelContext
from .mlp import mlp_apply, mlp_init
from .ssm import (rwkv6_channel_mix, rwkv6_channel_mix_init, rwkv6_init,
                  rwkv6_time_mix)


def check_ported(cfg) -> None:
    if (cfg.family not in ("dense", "ssm") or cfg.is_encoder_decoder
            or cfg.frontend is not None):
        raise NotImplementedError(
            f"{cfg.name}: family '{cfg.family}' is not ported yet; the port "
            f"covers the dense family (slice 1) and the ssm family (slice 3), "
            f"the others are queued in ROADMAP.md")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm(cfg, seed: int = 0, *, device="cuda",
            dtype=torch.float32) -> Params:
    """Random parameters from ``seed`` (a ``torch.Generator`` on ``device``);
    the reference's layout and initializer scales, not its random numbers."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, L = cfg.d_model, (cfg.num_layers,)
    p: Params = {"embed": embed_init(gen, cfg.vocab_size, d, dtype),
                 "ln_f": norm_init(cfg.norm, d, device=dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, d, cfg.vocab_size, dtype=dtype)
    p["layers"] = {
        "ln1": norm_init(cfg.norm, d, lead=L, device=dev),
        "ln2": norm_init(cfg.norm, d, lead=L, device=dev),
    }
    if cfg.family == "ssm":  # rwkv6
        p["layers"].update(
            tmix=rwkv6_init(gen, d, cfg.rwkv_head_dim, lead=L, dtype=dtype),
            cmix=rwkv6_channel_mix_init(gen, d, cfg.d_ff, lead=L,
                                        dtype=dtype))
        return p
    p["layers"].update(
        attn=attn_init(gen, d, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim_, cfg.qkv_bias, lead=L, dtype=dtype),
        mlp=mlp_init(gen, d, cfg.d_ff, cfg.act, lead=L, dtype=dtype))
    return p


def layer(params: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in params.items()}


def unstack(params: Params, n: int) -> List[Params]:
    """The ``n`` layers of a stacked tree as views, each leaf cut by one
    ``unbind``: its backward stacks the layers' grads once, where ``n``
    separate ``layer`` views would each add a full-size zero-padded grad."""
    out: List[Params] = [{} for _ in range(n)]
    for k, v in params.items():
        parts = unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for tree, part in zip(out, parts):
            tree[k] = part
    return out


def _lm_head(params: Params, cfg) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _fit_chunk(t: int, chunk: int) -> int:
    """Largest power-of-two-ish chunk <= `chunk` dividing sequence length."""
    c = min(chunk, t)
    while t % c:
        c //= 2
    return max(c, 1)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _dense_block(lp: Params, x: torch.Tensor, cfg, ctx: ModelContext,
                 positions: torch.Tensor, kv_sink=None) -> torch.Tensor:
    h = norm_apply(cfg.norm, lp["ln1"], x)
    h = ctx.shard(h, "dp", None, None)
    x = x + attention_block(lp["attn"], h, cfg, positions, kv_sink)
    x = ctx.shard(x, "dp", "sp", None)
    h = norm_apply(cfg.norm, lp["ln2"], x)
    h = ctx.shard(h, "dp", None, None)
    x = x + mlp_apply(lp["mlp"], h, cfg.act)
    return ctx.shard(x, "dp", "sp", None)


def _rwkv6_block(lp: Params, x: torch.Tensor, cfg, ctx: ModelContext,
                 chunk: int, sink=None) -> torch.Tensor:
    h = norm_apply(cfg.norm, lp["ln1"], x)
    y, st = rwkv6_time_mix(lp["tmix"], h, cfg.rwkv_head_dim, chunk=chunk)
    x = x + y
    h = norm_apply(cfg.norm, lp["ln2"], x)
    y, cmix_last = rwkv6_channel_mix(lp["cmix"], h)
    if sink is not None:
        sink.append((st["S"], st["last"], cmix_last))
    return ctx.shard(x + y, "dp", "sp", None)


# ---------------------------------------------------------------------------
# forward (prefill / teacher forcing)
# ---------------------------------------------------------------------------

def hidden_states(params: Params, cfg, tokens: torch.Tensor, *,
                  ctx: ModelContext = NULL_CTX,
                  sink: Optional[List] = None) -> torch.Tensor:
    """tokens (B, S), positions 0..S-1 -> final-norm hidden states (B, S, D)
    in the compute dtype.  ``sink`` collects each layer's decode state in
    order: dense, its post-RoPE (k, v); ssm, the recurrence's final S and
    the last position of the normed time-mix and channel-mix inputs.  Each
    layer's block runs under ``ctx.maybe_remat``."""
    check_ported(cfg)
    s = tokens.shape[1]
    x = params["embed"][tokens].to(compute_dtype(cfg))
    positions = torch.arange(s, device=tokens.device)[None]
    x = ctx.shard(x, "dp", "sp", None)
    if cfg.family == "ssm":
        block, extra = _rwkv6_block, _fit_chunk(s, ctx.ssm_chunk)
    else:
        block, extra = _dense_block, positions
    block = ctx.maybe_remat(block)
    for lp in unstack(params["layers"], cfg.num_layers):
        x = block(lp, x, cfg, ctx, extra, sink)
    return norm_apply(cfg.norm, params["ln_f"], x)


def logits_from_hidden(params: Params, cfg, x: torch.Tensor,
                       ctx: ModelContext = NULL_CTX) -> torch.Tensor:
    logits = x @ _lm_head(params, cfg).to(x.dtype)
    return ctx.shard(logits, "dp", None, "tp")


def forward(params: Params, cfg, tokens: torch.Tensor, *,
            ctx: ModelContext = NULL_CTX
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) in the compute dtype, aux loss).

    As in the reference, the aux loss is a float32 scalar, 0 for the dense
    and ssm families (only MoE layers add to it)."""
    x = hidden_states(params, cfg, tokens, ctx=ctx)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return logits_from_hidden(params, cfg, x, ctx), aux


def lm_loss(params: Params, cfg, tokens: torch.Tensor, labels: torch.Tensor,
            *, ctx: ModelContext = NULL_CTX, aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy in float32 plus ``aux_weight`` x the
    aux loss (``transformer.py:340-349``): (loss, {"nll", "aux"}).

    Training passes the float32 master tree with ``requires_grad``, never
    ``LM.compute_params()`` (detached): the blocks cast each weight to the
    compute dtype inside the graph, so grads reach the masters in float32,
    as the reference's do."""
    logits, aux = forward(params, cfg, tokens, ctx=ctx)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# module
# ---------------------------------------------------------------------------

# leaves the compute copy keeps in float32, as the reference reads them:
# norm params (norm_apply), and the RWKV6 decay base and bonus, which enter
# float32 arithmetic (ssm.py:264 and :100-101)
_KEEP_DTYPE = ("scale", "bias", "decay_base", "bonus_u")


def _flatten(tree: Params, prefix: str = ""
             ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """(leaves by path, paths of the empty subtrees).  A ``nonparam_ln``
    norm is an empty subtree ({}), which has no leaf to carry it."""
    out, empty = {}, []
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            sub, sub_empty = _flatten(v, f"{prefix}{k}/")
            out.update(sub)
            empty += sub_empty
        elif isinstance(v, dict):
            empty.append(prefix + k)
        else:
            out[prefix + k] = v
    return out, empty


def _unflatten(flat: Dict[str, torch.Tensor],
               empty: Sequence[str] = ()) -> Params:
    tree: Params = {}
    for path, v in (*flat.items(), *((p, {}) for p in empty)):
        *dirs, leaf = path.split("/")
        node = tree
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = v
    return tree


class LM(nn.Module):
    """Owns the stacked float32 parameters of one LM and calls the
    functional code.

    ``compute_params()`` is the tree the entry points pass on: in bf16
    configs it holds one bf16 copy of every other leaf, made once.  The
    reference casts the same float32 values to bf16 where it uses them, so
    the copy is bit-identical to that cast; the leaves of ``_KEEP_DTYPE``
    stay float32, as the reference reads them."""

    def __init__(self, cfg, params: Params):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        flat, self._empty = _flatten(params)
        self.weights = nn.ParameterDict({
            path: nn.Parameter(t, requires_grad=False)
            for path, t in flat.items()})
        self._compute: Optional[Params] = None

    @classmethod
    def init(cls, cfg, seed: int = 0, *, device="cuda") -> "LM":
        return cls(cfg, init_lm(cfg, seed, device=device))

    @property
    def params(self) -> Params:
        return _unflatten(dict(self.weights.items()), self._empty)

    def compute_params(self) -> Params:
        if self._compute is None:
            dt = compute_dtype(self.cfg)
            self._compute = _unflatten({
                path: (w.detach() if path.rsplit("/", 1)[-1] in _KEEP_DTYPE
                       else w.detach().to(dt))
                for path, w in self.weights.items()}, self._empty)
        return self._compute

    def _apply(self, fn, *args, **kwargs):
        self._compute = None          # .to() / .cuda(): the copy is remade
        return super()._apply(fn, *args, **kwargs)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V); the aux loss is dropped."""
        return forward(self.compute_params(), self.cfg, tokens)[0]
