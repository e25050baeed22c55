"""Nemotron-4-340B [arXiv:2402.16819; dense].

96L, d_model 18432, 96 heads (GQA kv=8, head_dim 192), d_ff 73728,
vocab 256000, squared-ReLU MLP (non-gated), LayerNorm, RoPE.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    head_dim=192, d_ff=73728, vocab_size=256000,
    act="relu2", norm="layernorm", rope_theta=1e4,
))
