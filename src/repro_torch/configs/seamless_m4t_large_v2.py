"""SeamlessM4T-Large-v2 [arXiv:2308.11596] text backbone: encoder-decoder,
24 encoder + 24 decoder layers, d_model 1024, 16 heads, d_ff 8192,
vocab 256206.

The speech frontend (w2v-BERT conformer) is a STUB per the assignment:
``input_specs()`` supplies precomputed frame embeddings [B, S, d_model] as
the encoder input; the backbone (this config) is what the framework lowers.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,  # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    rope_theta=10_000.0,
    ffn_act="gelu",
    norm="layernorm",
    frontend="audio",
    tie_embeddings=True,
)
