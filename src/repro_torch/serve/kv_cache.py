"""Decode state: per-layer KV caches (dense, vlm, moe, audio), recurrent
states (ssm, hybrid), cross-attention caches (audio).

Layouts as the reference's:
  dense   k/v ``(L, B, cap, Hkv, hd)``, ``cap = min(max_len, window or inf)``;
          SWA caches are rolling, slot = pos % cap; the vlm family's too
  moe     the same for the MoE layers (leading axis L - moe_first_dense),
          and ``k_cache_dense`` / ``v_cache_dense`` for the leading dense
          layers (``moe_first_dense``), where there are any
  rwkv6   ``rwkv_S`` (L, B, H, K, V) float32; ``tmix_last`` / ``cmix_last``
          (L, B, D), the last normed time-mix / channel-mix inputs, in the
          compute dtype; O(1) in the context length
  hybrid  ``mamba_ssm`` (L, B, H, K, hd) float32 and ``mamba_conv``
          (L, B, 3, D_inner), the conv's trailing context, in the compute
          dtype, per Mamba2 block; ``k_cache`` / ``v_cache`` (L /
          attn_every, B, cap, Hkv, hd), one per application point of the
          shared block
  audio   the decoder's self-attention k/v as dense, and ``cross_k`` /
          ``cross_v`` ``(L, B, max_len, Hkv, hd)``, the encoder's output
          projected by each layer's cross attention (trimmed or zero-padded
          to ``max_len`` rows), in the same dtype; ``enc_len``, an int, the
          encoder's length, not clamped to ``max_len``
``cache_len`` is a Python int, the number of tokens already written.  Unlike
the reference's functional updates, the port writes the state in place.

Under a mesh (``init_decode_state(..., view=)``) every tensor of the state is
a DTensor laid out as the reference's ``decode_state_specs`` lays it out
(``launch.dryrun.state_spec``): the caches' batch over dp and their
sequence (slots) over tp, the recurrent states' heads over "a", the token
shifts and the conv context over tp.  Each rank reads and writes its own
block in place: ``layer_of`` is a layer's view, ``store`` writes a layer
from a tensor of any layout, and ``cache_write`` / ``fill_cache`` write the
slots a rank owns.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..device import is_dtensor, resolve_device
from ..models.transformer import attention_stacks, ssm_heads


def attn_cache_len(cfg, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_decode_state(cfg, batch: int, max_len: int, *,
                      dtype=torch.bfloat16, device="cuda",
                      view=None) -> Dict[str, Any]:
    """Zeroed decode state for one model; on the mesh view ``view`` (every
    rank calls it), each tensor a DTensor of zeros in the layout of
    ``launch.dryrun.state_spec``, each rank allocating only its block."""
    if view is not None:
        return _on_view(cfg, batch, max_len, dtype, view)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        h, k = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        last = (cfg.num_layers, batch, cfg.d_model)
        return {"cache_len": 0,
                "rwkv_S": torch.zeros((cfg.num_layers, batch, h, k, k),
                                      dtype=torch.float32, device=dev),
                "tmix_last": torch.zeros(last, dtype=dtype, device=dev),
                "cmix_last": torch.zeros(last, dtype=dtype, device=dev)}
    if cfg.family == "hybrid":
        h, d_in = ssm_heads(cfg), cfg.d_model * cfg.ssm_expand
        kv = (cfg.num_layers // cfg.attn_every, batch,
              attn_cache_len(cfg, max_len), cfg.num_kv_heads, cfg.head_dim_)
        return {"cache_len": 0,
                "mamba_ssm": torch.zeros(
                    (cfg.num_layers, batch, h, cfg.ssm_state, d_in // h),
                    dtype=torch.float32, device=dev),
                "mamba_conv": torch.zeros((cfg.num_layers, batch, 3, d_in),
                                          dtype=dtype, device=dev),
                "k_cache": torch.zeros(kv, dtype=dtype, device=dev),
                "v_cache": torch.zeros(kv, dtype=dtype, device=dev)}
    state: Dict[str, Any] = {"cache_len": 0}
    for key, n, _ in attention_stacks(cfg):
        shape = (n, batch, attn_cache_len(cfg, max_len), cfg.num_kv_heads,
                 cfg.head_dim_)
        for name in cache_names(key):
            state[name] = torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.is_encoder_decoder:
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.head_dim_)
        state["cross_k"] = torch.zeros(shape, dtype=dtype, device=dev)
        state["cross_v"] = torch.zeros(shape, dtype=dtype, device=dev)
        state["enc_len"] = 0
    return state


def _on_view(cfg, batch: int, max_len: int, dtype, view) -> Dict[str, Any]:
    from torch.distributed.tensor import DTensor, Shard

    from ..launch.dryrun import state_spec
    from ..parallel.sharding import compute_mesh, spec_placements
    mesh = compute_mesh(view)
    out: Dict[str, Any] = {}
    for name, leaf in init_decode_state(cfg, batch, max_len, dtype=dtype,
                                        device="meta").items():
        if not isinstance(leaf, torch.Tensor):
            out[name] = leaf
            continue
        pl = spec_placements(state_spec(name, leaf, batch, view), view)
        local = list(leaf.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                local[p.dim] //= mesh.size(i)
        out[name] = DTensor.from_local(
            torch.zeros(local, dtype=leaf.dtype,
                        device=resolve_device(mesh.device_type)),
            mesh, pl, run_check=False, shape=leaf.shape,
            stride=leaf.stride())
    return out


def layer_of(t: torch.Tensor, i: int) -> torch.Tensor:
    """Layer ``i`` of a stacked state tensor, a view: under a mesh the
    DTensor over each rank's view of its block (no layout splits the layer
    axis)."""
    if not is_dtensor(t):
        return t[i]
    from torch.distributed.tensor import DTensor, Shard
    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p
          for p in t.placements]
    local = t.to_local()[i]
    return DTensor.from_local(local, t.device_mesh, pl, run_check=False,
                              shape=t.shape[1:],
                              stride=torch.empty(t.shape[1:],
                                                 device="meta").stride())


def store(t: torch.Tensor, i: int, value: torch.Tensor) -> None:
    """Layer ``i`` of ``t`` := ``value`` in ``t``'s dtype, in place; under a
    mesh ``value`` (a DTensor in any layout) is laid out as the layer and
    each rank copies its block."""
    if not is_dtensor(t):
        t[i] = value
        return
    dst = layer_of(t, i)
    dst.to_local().copy_(value.redistribute(dst.device_mesh, dst.placements)
                         .to_local())


def write_slots(cache: torch.Tensor, new: torch.Tensor, first: int) -> None:
    """Positions ``first`` .. ``first + n - 1`` of ``new`` (B, n, Hkv, hd)
    into one layer's cache (B, cap, Hkv, hd) at slots pos % cap, in place,
    in the cache dtype (n <= cap).  Under a mesh the cache's slots are
    split over the tp dims: ``new`` is laid out with the cache's batch
    split and its positions whole, and each rank writes the positions
    whose slots it holds, the rolling ones included."""
    cap, n = cache.shape[1], new.shape[1]
    local, lo = cache, 0
    if is_dtensor(cache):
        from torch.distributed.tensor import Replicate, Shard

        from ..parallel.sharding import shard_block
        mesh, pl = cache.device_mesh, cache.placements
        new = new.redistribute(mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in pl]).to_local()
        local = cache.to_local()
        lo = shard_block(mesh, [d for d, p in enumerate(pl) if
                                isinstance(p, Shard) and p.dim == 1]) \
            * local.shape[1]
    # n <= cap, so the positions' slots are at most two runs of consecutive
    # slots (one wrap); each run's overlap with this rank's block is one
    # slice of the cache, computed from Python ints (no index tensor, no
    # data-dependent op: a fake cache takes it too, the dry run)
    s0 = first % cap
    wrap = min(n, cap - s0)
    for i0, slot0, length in ((0, s0, wrap), (wrap, 0, n - wrap)):
        a = max(slot0, lo)
        b = min(slot0 + length, lo + local.shape[1])
        if a < b:
            local[:, a - lo:b - lo] = \
                new[:, i0 + a - slot0:i0 + b - slot0].to(local.dtype)


def fill_cache(kc: torch.Tensor, vc: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> None:
    """A prompt's K/V (B, S, Hkv, hd) into one layer's cache (B, cap, Hkv,
    hd), in the cache dtype, at slots pos % cap: for a rolling cache
    shorter than the prompt, only the last ``cap`` positions, the ones a
    token-by-token prefill leaves behind."""
    first = max(0, k.shape[1] - kc.shape[1])
    write_slots(kc, k[:, first:], first)
    write_slots(vc, v[:, first:], first)


def cache_names(stack: str) -> Tuple[str, str]:
    """The k and v cache keys of a stack of ``attention_stacks``."""
    suffix = "_dense" if stack == "dense_layers" else ""
    return f"k_cache{suffix}", f"v_cache{suffix}"


def cache_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor, pos: int) -> None:
    """Write one token (B, 1, Hkv, hd) at slot pos % cap, in place (under a
    mesh, on the rank holding the slot)."""
    write_slots(k_cache, k_new, pos)
    write_slots(v_cache, v_new, pos)
