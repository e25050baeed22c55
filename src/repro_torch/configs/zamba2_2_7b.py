"""Zamba2-2.7B [arXiv:2411.15242; hybrid].

54 Mamba2 blocks (d_model 2560, ssm_state 64, 40 SSM heads of 128) with a
single SHARED attention+MLP transformer block (32 heads of 80, d_ff 10240)
applied every 6 Mamba blocks on concat(h, x0): the Zamba parameter-sharing
signature.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    head_dim=80, d_ff=10240, vocab_size=32000,
    act="gelu", norm="rmsnorm", rope_theta=1e4,
    ssm_state=64, ssm_heads=40, ssm_expand=2, attn_every=6,
))
