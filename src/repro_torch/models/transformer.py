"""The decoder-only LM for the dense attention kinds and RWKV-6, driven
entirely by :class:`repro_torch.configs.ModelConfig`.

The port's counterpart of the reference's ``repro/models/transformer.py``,
serving surface only:

* ``init(generator)`` — parameter tree (segment-stacked; see blocks.py),
  drawn from an explicit ``torch.Generator``;
* ``prefill(params, batch)`` — full-sequence forward building decode caches;
* ``decode_step(params, caches, tokens, pos)`` — one token for the batch;
* ``init_cache(batch, max_seq)`` — decode-state tree.

The cache layout is the reference's: one dict per segment,
``{str(i): {"k", "v": [R, B, max_seq, nkv, hd]}}`` with R the segment's
layers, or ``{str(i): {"S", "tm_prev", "cm_prev"}}`` for ``rwkv``.
``loss`` waits for the training slice; the encoder-decoder and
vision front ends wait with their kinds (ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cms_sketch import resolve_device

from .attention import PhysPlan
from .blocks import apply_superblock, init_segment, init_segment_cache, layer, scan_segment_decode
from .common import Tensor, apply_norm, embed_tokens, init_embed, init_norm, lm_logits


@dataclasses.dataclass
class LM:
    """``device`` is where parameters and caches live: ``"cuda"`` unless the
    caller asks for the CPU (a CUDA device without CUDA raises)."""

    cfg: ModelConfig
    plan: PhysPlan | None = None
    dtype: torch.dtype = torch.float32
    device: torch.device | str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.plan is None:
            self.plan = PhysPlan.make(self.cfg, tp=1)
        if self.cfg.frontend != "none" or self.cfg.is_encdec:
            raise NotImplementedError(
                f"{self.cfg.name}: the {self.cfg.frontend} front end / encoder-decoder is not "
                "ported yet (ROADMAP queue 1, item 12)")
        self.segments = self.cfg.layer_plan()

    # -- params ------------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        cfg, kw = self.cfg, {"dtype": self.dtype, "device": self.device}
        return {
            "embed": init_embed(generator, cfg, **kw),
            "final_norm": init_norm(cfg, **kw),
            "segments": [init_segment(generator, cfg, seg, self.plan, **kw)
                         for seg in self.segments],
        }

    # -- helpers ------------------------------------------------------------
    def _embed(self, params, tokens: Tensor) -> Tensor:
        x = embed_tokens(params["embed"], tokens)
        if self.cfg.embed_scale:  # gemma-style embedding scaling
            x = x * self.cfg.d_model ** 0.5
        return x

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int) -> list:
        return [init_segment_cache(self.cfg, seg, self.plan, batch, max_seq, self.dtype,
                                   self.device)
                for seg in self.segments]

    def prefill(self, params, batch: dict, max_seq: int | None = None, *,
                use_kernel: bool = True):
        """Run the full prompt, returning (last-token logits [B,V], caches).
        ``use_kernel=False`` runs the plain versions of the flash and wkv6
        kernels on the card."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        max_seq = max_seq or S
        caches = []
        for seg_p, seg in zip(params["segments"], self.segments):
            x, seg_cache = _prefill_segment(seg_p, cfg, seg, self.plan, x, positions, max_seq,
                                            dtype=self.dtype, use_kernel=use_kernel)
            caches.append(seg_cache)
        x = apply_norm(params["final_norm"], x)
        logits = lm_logits(params["embed"], x[:, -1:], cfg)[:, 0]
        return logits, caches

    def decode_step(self, params, caches, tokens: Tensor, pos: int):
        """tokens: [B] int; pos: int. Returns (logits [B,V], caches); the
        caches are updated in place (the reference returns new ones)."""
        x = self._embed(params, tokens[:, None])
        for seg_p, seg_c, seg in zip(params["segments"], caches, self.segments):
            x = scan_segment_decode(seg_p, seg_c, self.cfg, seg, x, pos)
        x = apply_norm(params["final_norm"], x)
        return lm_logits(params["embed"], x, self.cfg)[:, 0], caches


def _prefill_segment(seg_p, cfg, seg, plan, x, positions, max_seq, *, dtype, use_kernel):
    """Full-sequence pass over one segment that also writes each layer's
    K/V (or recurrent state) into the segment's decode cache as the layer
    produces it."""
    B, S = x.shape[0], x.shape[1]
    cache = init_segment_cache(cfg, seg, plan, B, max_seq, dtype, x.device)
    for r in range(seg.repeat):
        x, kvs = apply_superblock(layer(seg_p, r), cfg, seg.kinds, x, positions,
                                  collect_kv=True, use_kernel=use_kernel)
        for key, payload in kvs.items():
            if seg.kinds[int(key)] == "rwkv":  # the state after the prompt
                for name, value in payload.items():
                    cache[key][name][r].copy_(value)
                continue
            k, v = payload
            ck, cv = cache[key]["k"][r], cache[key]["v"][r]  # [B, S_cache, nkv, hd]
            W = ck.shape[1]
            if seg.kinds[int(key)] == "dense_local" and S >= W:
                # ring cache: token at absolute position p sits at p % W
                shift = S % W
                ck.copy_(torch.roll(k[:, -W:], shift, dims=1))
                cv.copy_(torch.roll(v[:, -W:], shift, dims=1))
            elif S > W:
                raise ValueError(f"prompt of {S} tokens does not fit max_seq={W}")
            else:
                ck[:, :S] = k
                cv[:, :S] = v
    return x, cache
