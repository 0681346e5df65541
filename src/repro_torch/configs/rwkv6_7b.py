"""RWKV-6 (Finch) 7B [arXiv:2404.05892]: attention-free, data-dependent
decay linear recurrence (wkv6), token-shift mixing.

32L, d_model 4096 (64 heads x 64), channel-mix d_ff 14336, vocab 65536.
Sub-quadratic: runs the long_500k shape (O(1) wkv state per layer).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,  # d_model / rwkv_head_dim
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    head_dim=64,
    rwkv_head_dim=64,
    norm="layernorm",
    sub_quadratic=True,
)
