"""InternVL2-1B [arXiv:2404.16821] LM backbone (Qwen2-0.5B class):
24L, d_model 896, 14 heads (GQA kv=2), d_ff 4864, vocab 151655.

The InternViT-300M vision frontend is a STUB per the assignment:
``input_specs()`` supplies ``num_frontend_tokens`` precomputed patch
embeddings [B, N_img, d_model] prepended to the token embeddings.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    ffn_act="swiglu",
    frontend="vision",
    num_frontend_tokens=256,
    tie_embeddings=True,
)
