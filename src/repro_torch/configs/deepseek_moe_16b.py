"""DeepSeekMoE-16B [arXiv:2401.06066; moe].

28L, d_model 2048, 16 heads (kv=16, head_dim 128), vocab 102400.
Fine-grained experts: 64 routed (top-6) + 2 shared, per-expert d_ff 1408;
layer 0 is dense with d_ff 10944.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    act="silu", norm="rmsnorm", rope_theta=1e4,
    moe_num_experts=64, moe_top_k=6, moe_shared_experts=2,
    moe_d_ff=1408, moe_first_dense=1,
))
