"""Phi-3-vision-4.2B backbone [hf:microsoft/Phi-3-vision-128k-instruct; vlm].

The phi3-mini transformer backbone: 32 layers, d_model 3072, 32 heads of 96
(32 kv heads), gated silu d_ff 8192, RMSNorm, vocab 32064.  The CLIP
frontend is a stub: callers hand over precomputed patch embeddings
(B, num_patches, d_model), which ``patch_proj`` projects into the first
``num_patches`` positions of the sequence.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    act="silu", norm="rmsnorm", rope_theta=1e4,
    frontend="patch", num_patches=256,
))
