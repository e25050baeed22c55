"""Decode state of the dense family: per-layer KV caches.

Layout as the reference's: k/v ``(L, B, cap, Hkv, hd)``, with
``cap = min(max_len, window or inf)``; SWA caches are rolling, slot =
pos % cap.  ``cache_len`` is a Python int, the number of tokens already
written.  Unlike the reference's functional updates, the port writes the
caches in place.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..device import resolve_device


def attn_cache_len(cfg, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_decode_state(cfg, batch: int, max_len: int, *,
                      dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """Zeroed caches for one dense model."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, attn_cache_len(cfg, max_len),
             cfg.num_kv_heads, cfg.head_dim_)
    return {"cache_len": 0,
            "k_cache": torch.zeros(shape, dtype=dtype, device=dev),
            "v_cache": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor, pos: int) -> None:
    """Write one token (B, 1, Hkv, hd) at slot pos % cap, in place."""
    slot = pos % k_cache.shape[1]
    k_cache[:, slot] = k_new[:, 0]
    v_cache[:, slot] = v_new[:, 0]
