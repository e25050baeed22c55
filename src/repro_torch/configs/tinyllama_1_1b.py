"""TinyLlama-1.1B [arXiv:2401.02385; dense llama2-arch small].

22L, d_model 2048, 32 heads (GQA kv=4, head_dim 64), d_ff 5632, vocab 32000.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="tinyllama-1.1b", family="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=5632, vocab_size=32000,
    act="silu", norm="rmsnorm", rope_theta=1e4,
))
