"""RecurrentGemma-2B [arXiv:2402.19427] (Griffin): RG-LRU recurrent blocks
with local attention at a 1:2 ratio — pattern (recurrent, recurrent, local).

26L, d_model 2560, 10 heads (MQA kv=1, head_dim 256), d_ff 7680,
lru_width 2560, conv width 4, local window 2048, vocab 256000.
Sub-quadratic: runs the long_500k shape (O(1) recurrent state + fixed
attention window).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    local_window=2048,
    lru_width=2560,
    conv_width=4,
    hybrid_period=3,
    ffn_act="geglu",
    tie_embeddings=True,
    embed_scale=True,
    sub_quadratic=True,
)
