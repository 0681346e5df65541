"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01]: GQA, no biases,
parallel attention/FFN block, layernorm (Cohere style).

40L, d_model 8192, 64 heads (GQA kv=8), d_ff 22528, vocab 256000.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    rope_theta=8_000_000.0,
    parallel_block=True,
    qkv_bias=False,
    ffn_act="swiglu",
    norm="layernorm",
    tie_embeddings=True,
)
