"""Whisper-base backbone [arXiv:2212.04356; audio enc-dec].

6 encoder + 6 decoder layers, d_model 512, 8 heads of 64, d_ff 2048, gelu,
LayerNorm, vocab 51865: OpenAI whisper's ``base`` dimensions, whose audio
context is 1500 frames (``n_audio_ctx``) and whose text context is 448
tokens (``n_text_ctx``).  The conv frame frontend is a stub: callers hand
over frame embeddings (B, S_enc, d_model); the decoder cross-attends to the
encoder's output.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, encoder_layers=6, is_encoder_decoder=True,
    d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    act="gelu", norm="layernorm", rope_theta=1e4,
    frontend="frames",
))
