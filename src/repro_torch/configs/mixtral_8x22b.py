"""Mixtral-8x22B [arXiv:2401.04088; moe].

56L, d_model 6144, 48 heads (GQA kv=8, head_dim 128), per-expert d_ff
16384, vocab 32768; 8 experts top-2; sliding-window attention (4096), which
bounds the KV cache.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768,
    act="silu", norm="rmsnorm", rope_theta=1e6,
    moe_num_experts=8, moe_top_k=2, moe_d_ff=16384,
    sliding_window=4096,
))
