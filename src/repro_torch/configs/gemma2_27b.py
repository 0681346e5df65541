"""Gemma2-27B [arXiv:2408.00118]: local+global alternating attention,
attention/final logit soft-capping, GeGLU.

46L, d_model 4608, 32 heads (GQA kv=16), d_ff 36864, vocab 256000.
head_dim is 128 (published config; d_model/num_heads = 144 is NOT used).
query_pre_attn_scalar = d_model / num_heads = 144 (gemma2-27b quirk).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    rope_theta=10_000.0,
    attn_pattern=("local", "global"),
    local_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_pre_attn_scalar=144.0,
    ffn_act="geglu",
    tie_embeddings=True,
    embed_scale=True,
)
