"""OLMo-1B [arXiv:2402.00838; dense].

16L, d_model 2048, 16 heads (kv=16), d_ff 8192, vocab 50304.
Signature: non-parametric LayerNorm (no scale/bias), SwiGLU, tied embeddings.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmo-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=50304,
    act="silu", norm="nonparam_ln", tie_embeddings=True, rope_theta=1e4,
))
