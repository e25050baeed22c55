"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family; dense].

64L, d_model 5120, 40 heads (GQA kv=40 ⇒ effectively MHA), d_ff 27392,
vocab 152064, QKV bias (the Qwen1.5 signature), SwiGLU, RMSNorm, RoPE.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27392, vocab_size=152064,
    act="silu", norm="rmsnorm", qkv_bias=True, rope_theta=1e6,
))
