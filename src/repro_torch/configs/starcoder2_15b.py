"""StarCoder2-15B [arXiv:2402.19173]: dense GQA decoder, RoPE.

40L, d_model 6144, 48 heads (GQA kv=4), d_ff 24576, vocab 49152.
StarCoder2 uses (gelu) MLP and learned attention with biases; sliding-window
in some variants — the 15B config here is full attention.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    rope_theta=100_000.0,
    qkv_bias=True,
    ffn_act="gelu",
    norm="layernorm",
)
