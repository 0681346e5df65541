"""DeepSeek-V2-Lite 16B [arXiv:2405.04434]: Multi-head Latent Attention
(MLA, kv_lora_rank=512) + fine-grained MoE.

27L, d_model 2048, 16 heads, routed-expert d_ff 1408, vocab 102400.
MoE: 64 routed experts top-6 + 2 shared experts; first layer is dense
(d_ff 10944). The assignment line says "2 shared+160 routed" — 160 is
DeepSeek-V2-236B's count; the Lite model (this arch id) has 64 routed
(hf config), which we follow. Noted in DESIGN.md.
"""

from .base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MLA: latent cache is shared; head count = 16
    d_ff=10944,  # first dense layer width
    vocab_size=102400,
    head_dim=128,
    rope_theta=10_000.0,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    ffn_act="swiglu",
    moe=MoESpec(
        num_experts=64,
        top_k=6,
        d_ff_expert=1408,
        num_shared=2,
        first_dense_layers=1,
        capacity_factor=1.5,
    ),
)
