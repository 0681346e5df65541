"""Model/config schema shared by all ten assigned architectures.

The port's copy of the reference's ``repro/configs/base.py``, with the same
published numbers. A :class:`ModelConfig` fully determines parameter shapes,
the layer plan (homogeneous segments whose layers are stacked on a leading
``[repeat]`` axis), and the serving state layout. Every architecture file in
this package exports ``CONFIG`` with the exact published numbers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

__all__ = ["MoESpec", "ModelConfig", "Segment", "SHAPES", "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0  # shared (always-on) experts, DeepSeek-style
    dense_residual: bool = False  # parallel dense FFN, Arctic-style
    first_dense_layers: int = 0  # leading layers with dense FFN (DeepSeek)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class Segment:
    """``repeat`` homogeneous super-blocks, each a tuple of sub-layer kinds.

    Sub-layer kinds: ``dense`` (global attn + FFN), ``dense_local``
    (windowed attn + FFN), ``moe`` (attn + MoE FFN), ``mla_dense`` /
    ``mla_moe`` (DeepSeek MLA attention), ``rglru`` (Griffin recurrent
    block), ``rwkv`` (RWKV6 time-mix + channel-mix), ``enc`` (bidirectional
    attn + FFN), ``dec`` (self-attn + cross-attn + FFN).
    """

    kinds: tuple[str, ...]
    repeat: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // num_heads

    # attention flavour
    rope_theta: float = 10_000.0
    local_window: int = 4096
    attn_pattern: tuple[str, ...] = ("global",)  # cycled over layers
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    parallel_block: bool = False  # attn & FFN in parallel (Cohere)
    qkv_bias: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    ffn_act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    query_pre_attn_scalar: float | None = None  # gemma2-style custom scale

    # MLA (DeepSeek)
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # MoE
    moe: MoESpec | None = None

    # recurrent / hybrid (Griffin)
    lru_width: int | None = None
    conv_width: int = 4
    hybrid_period: int = 3  # (rglru, rglru, attn) per period
    # rwkv
    rwkv_head_dim: int = 64
    # encoder-decoder
    encoder_layers: int = 0
    # modality frontend stubs
    frontend: Literal["none", "audio", "vision"] = "none"
    num_frontend_tokens: int = 256  # vision: patch embeds prepended

    # physical padding for shardability (Megatron-style)
    pad_vocab_multiple: int = 128
    sub_quadratic: bool = False  # may run the long_500k shape

    # ---------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_plan(self) -> list[Segment]:
        """Decoder layer plan as homogeneous scannable segments."""
        n = self.num_layers
        if self.family == "ssm":
            return [Segment(("rwkv",), n)]
        if self.lru_width is not None:  # Griffin hybrid: (rec, rec, attn)*
            period = self.hybrid_period
            full, extra = divmod(n, period)
            kinds = ("rglru",) * (period - 1) + ("dense_local",)
            segs = [Segment(kinds, full)]
            if extra:
                segs.append(Segment(("rglru",) * extra, 1))
            return segs
        if self.is_encdec:
            return [Segment(("dec",), n)]
        if self.moe is not None:
            fd = self.moe.first_dense_layers
            kind = "mla_moe" if self.use_mla else "moe"
            dense_kind = "mla_dense" if self.use_mla else "dense"
            segs = []
            if fd:
                segs.append(Segment((dense_kind,), fd))
            segs.append(Segment((kind,), n - fd))
            return segs
        if len(self.attn_pattern) > 1:  # e.g. gemma2 (local, global)
            period = len(self.attn_pattern)
            assert n % period == 0, f"{self.name}: layers {n} % pattern {period}"
            kinds = tuple(
                "dense_local" if p == "local" else "dense" for p in self.attn_pattern
            )
            return [Segment(kinds, n // period)]
        kind = "dense_local" if self.attn_pattern[0] == "local" else "dense"
        return [Segment((kind,), n)]

    def encoder_plan(self) -> list[Segment]:
        return [Segment(("enc",), self.encoder_layers)] if self.is_encdec else []

    def param_count(self) -> int:
        """Analytic parameter count (documented in EXPERIMENTS.md roofline)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        V = self.padded_vocab
        total = V * d  # embed
        if not self.tie_embeddings:
            total += V * d
        glu = self.ffn_act in ("swiglu", "geglu")

        def ffn_params(ff):
            return d * ff * (3 if glu else 2)

        def attn_params():
            if self.use_mla:
                qdim = nq * (self.qk_nope_dim + self.qk_rope_dim)
                return (
                    d * qdim
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * nq * (self.qk_nope_dim + self.v_head_dim)
                    + nq * self.v_head_dim * d
                )
            return d * hd * (nq + 2 * nkv) + nq * hd * d

        def rglru_params():
            w = self.lru_width
            # in/gate proj, conv, gates, out proj
            return d * w * 2 + self.conv_width * w + 2 * w * (w // 8) * 2 + w * d + ffn_params(self.d_ff)

        def rwkv_params():
            heads = d // self.rwkv_head_dim
            tm = 4 * d * d + d * heads * 0 + 6 * d * 32 * 2  # r,k,v,g,o + ddlerp loras
            tm += d * d  # output
            cm = 2 * d * self.d_ff  # rwkv channel mix: k,v (+r gate on d)
            cm += d * d
            return tm + cm

        for seg in self.layer_plan():
            for kind in seg.kinds:
                if kind == "rwkv":
                    total += seg.repeat * rwkv_params()
                elif kind == "rglru":
                    total += seg.repeat * rglru_params()
                else:
                    lp = attn_params() + (attn_params() if kind == "dec" else 0)
                    if kind in ("moe", "mla_moe"):
                        m = self.moe
                        lp += m.num_experts * (m.d_ff_expert * d * (3 if glu else 2))
                        lp += m.num_shared * (m.d_ff_expert * d * (3 if glu else 2))
                        if m.dense_residual:
                            lp += ffn_params(self.d_ff)
                        lp += d * m.num_experts  # router
                    else:
                        lp += ffn_params(self.d_ff)
                    total += seg.repeat * lp
        for seg in self.encoder_plan():
            total += seg.repeat * (attn_params() + ffn_params(self.d_ff))
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top-k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model
        glu = self.ffn_act in ("swiglu", "geglu")
        per_expert = m.d_ff_expert * d * (3 if glu else 2)
        n_moe_layers = self.num_layers - m.first_dense_layers
        inactive = n_moe_layers * (m.num_experts - m.top_k) * per_expert
        return self.param_count() - inactive

    def scaled_down(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe,
                num_experts=min(moe.num_experts, 4),
                top_k=min(moe.top_k, 2),
                d_ff_expert=64,
                num_shared=min(moe.num_shared, 1),
            )
        nh = min(self.num_heads, 4)
        nkv = max(1, min(self.num_kv_heads, 2))
        period = len(self.attn_pattern)
        if self.lru_width is not None:
            layers = self.hybrid_period + 1  # one full period + leftover
        elif self.is_encdec or period == 1:
            layers = 2
        else:
            layers = period
        small = dict(
            num_layers=layers,
            d_model=64,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            local_window=32,
            lru_width=64 if self.lru_width is not None else None,
            kv_lora_rank=32,
            qk_rope_dim=8,
            qk_nope_dim=16,
            v_head_dim=16,
            rwkv_head_dim=16,
            encoder_layers=2 if self.is_encdec else 0,
            num_frontend_tokens=8,
            pad_vocab_multiple=64,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """An assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
