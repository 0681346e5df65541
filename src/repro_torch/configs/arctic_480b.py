"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base]:
dense-MoE hybrid — every layer has attention + a 128-expert top-2 MoE FFN
+ a parallel dense residual FFN.

35L, d_model 7168, 56 heads (GQA kv=8), expert d_ff 4864, vocab 32000.
Note: 56 heads do not divide the 16-way model axis; the runtime pads heads
to 64 with mathematically-inert heads (zero output-projection rows) — see
DESIGN.md §6 and distributed/sharding.py.
"""

from .base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,  # dense residual FFN width
    vocab_size=32000,
    head_dim=128,
    rope_theta=10_000.0,
    ffn_act="swiglu",
    moe=MoESpec(
        num_experts=128,
        top_k=2,
        d_ff_expert=4864,
        dense_residual=True,
        capacity_factor=1.25,
    ),
)
