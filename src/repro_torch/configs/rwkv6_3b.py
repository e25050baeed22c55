"""RWKV6-World-3B "Finch" [arXiv:2404.05892; ssm / linear attention].

32L, d_model 2560, attention-free time-mix with data-dependent decay,
channel-mix FFN d_ff 8960 (squared-ReLU), vocab 65536, LayerNorm.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=8960, vocab_size=65536,
    act="relu2", norm="layernorm",
    rwkv_head_dim=64,
))
