"""Serving engine: model + scheduler + size-aware prefix cache.

The port's counterpart of the reference's ``repro/serving/engine.py``. On
each request it looks up the longest cached prefix, prefills only the
suffix, and offers the finished prompt back to the cache, where the
size-aware W-TinyLFU admission decides residency.

This is the B=1 tensor path of the reference, run on the model's device
(``"cuda"`` unless the caller built the model on the CPU).
Prompts past the model's ``FLASH_THRESHOLD`` prefill through the Hopper
flash-attention kernel, RWKV-6 prefills through the wkv6 kernel; the
prefix cache's ``sketch_backend=cms`` policy scores through the CMS
kernels. ``use_kernel=False`` runs the kernels' plain versions instead (on
the card), which is how a run is held against its plain twin.

KV payloads are stored *sliced to the prefix length* and re-padded on use,
so cache byte accounting matches tensor reality; a recurrent state
(``rwkv``) is stored whole, and only for a block-aligned prompt. The port
decodes in place, unlike the reference, so every stored leaf is a copy (a
slice would also keep the whole ``max_seq`` buffer alive), and a payload
taken for decoding is copied again (re-padded KV, cloned state): no decode
write reaches a stored entry.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core import PolicySpec
from repro_torch.core.cms_sketch import resolve_device

from .prefix_cache import PrefixCache, PrefixCacheConfig, kv_bytes_per_token
from .scheduler import Request, Scheduler, SchedulerConfig

__all__ = ["Engine", "EngineConfig"]

#: cache leaves with a sequence axis (axis 2), by the reference's names:
#: sliced to the prefix for storage, and (the first four) re-padded for use
_SEQ_LEAVES = ("k", "v", "c_kv", "k_rope", "xk", "xv")
_PAD_LEAVES = ("k", "v", "c_kv", "k_rope")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_seq: int = 256
    cache_capacity_bytes: int = 1 << 22
    cache_policy: str = "wtlfu-av"
    block_size: int = 8
    #: "sync" (verdict per offer); the reference's "async" pipeline is not
    #: ported yet and raises
    cache_admission: str = "sync"
    #: where the prefix cache's policy runs unless its spec names a device;
    #: None: the model's device, where its parameters and caches live
    device: str | None = None
    #: False: the plain versions of the flash, wkv6 and CMS kernels, on the card
    use_kernel: bool = True


class Engine:
    def __init__(self, model, params, cfg: EngineConfig):
        self.model = model
        self.params = params
        self.cfg = cfg
        device = model.device if cfg.device is None else resolve_device(cfg.device)
        bpt = kv_bytes_per_token(model.cfg,
                                 dtype_bytes=4 if model.dtype == torch.float32 else 2)
        spec = PolicySpec.parse(cfg.cache_policy)
        policy_kwargs = {}
        if "device" not in spec.params_dict:
            policy_kwargs["device"] = str(device)
        if not cfg.use_kernel and spec.params_dict.get("sketch_backend") == "cms":
            policy_kwargs["sketch_kwargs"] = {"use_kernel": False}
        self.prefix_cache = PrefixCache(
            PrefixCacheConfig(
                capacity_bytes=cfg.cache_capacity_bytes,
                block_size=cfg.block_size,
                bytes_per_token=bpt,
                policy=cfg.cache_policy,
                policy_kwargs=policy_kwargs,
                admission=cfg.cache_admission,
            )
        )
        self.scheduler = Scheduler(SchedulerConfig())
        self._rid = 0
        self.prefill_tokens_computed = 0
        self.prefill_tokens_saved = 0

    def _prefill(self, tokens: torch.Tensor):
        return self.model.prefill(self.params, {"tokens": tokens}, max_seq=self.cfg.max_seq,
                                  use_kernel=self.cfg.use_kernel)

    def _decode(self, caches, token: int, pos: int):
        tok = torch.tensor([token], dtype=torch.long, device=self.model.device)
        return self.model.decode_step(self.params, caches, tok, pos)

    # -- cache payload helpers ------------------------------------------------
    @staticmethod
    def _slice_caches(caches, n_tokens: int):
        """Copies for storage: the first n_tokens of each sequence leaf (the
        reference's names, ndim >= 4), every other leaf whole."""
        def f(name, leaf):
            if name in _SEQ_LEAVES and leaf.dim() >= 4:
                return leaf[:, :, :n_tokens].clone()
            return leaf.clone()

        return [{key: {name: f(name, leaf) for name, leaf in c.items()}
                 for key, c in seg.items()} for seg in caches]

    def _pad_caches(self, caches, n_tokens: int):
        """New caches for decoding from a stored payload: KV leaves of
        n_tokens re-padded to max_seq, as in the reference (which pads a
        windowed layer's stored prefix to max_seq too), every other leaf
        cloned, so decoding in place leaves the stored entry as it was."""
        def f(name, leaf):
            if name in _PAD_LEAVES and leaf.dim() >= 4 and leaf.shape[2] == n_tokens:
                new = leaf.new_zeros((*leaf.shape[:2], self.cfg.max_seq, *leaf.shape[3:]))
                new[:, :, :n_tokens] = leaf
                return new
            return leaf.clone()

        return [{key: {name: f(name, leaf) for name, leaf in c.items()}
                 for key, c in seg.items()} for seg in caches]

    # -- generation -------------------------------------------------------------
    def _payload_usable(self, prompt_len: int, full_blocks: int) -> bool:
        """Recurrent state is not position-sliceable: only block-aligned
        prompts store usable payloads for recurrent archs; windowed
        attention payloads must fit inside the window (ring not yet rolled)."""
        cfg = self.model.cfg
        kinds = {k for seg in cfg.layer_plan() for k in seg.kinds}
        if kinds & {"rwkv", "rglru"} and full_blocks != prompt_len:
            return False
        if "dense_local" in kinds and prompt_len > cfg.local_window:
            return False
        return True

    def _argmax(self, logits) -> int:
        return int(torch.argmax(logits[0, : self.model.cfg.vocab_size]))

    @torch.inference_mode()
    def _run_request(self, prompt: list[int], max_new_tokens: int) -> dict:
        cfg = self.cfg
        t0 = time.perf_counter()
        prompt = list(prompt)
        cached_tokens, entry = self.prefix_cache.lookup(prompt)
        # a fully-cached prompt still needs the last token's logits
        cached_tokens = min(cached_tokens, len(prompt) - 1)
        if cached_tokens and entry is not None and entry.payload is not None:
            caches = self._pad_caches(entry.payload, cached_tokens)
            pos = cached_tokens
            # extend through remaining prompt tokens
            for i in range(cached_tokens, len(prompt)):
                logits, caches = self._decode(caches, prompt[i], i)
                pos = i + 1
            self.prefill_tokens_computed += len(prompt) - cached_tokens
            self.prefill_tokens_saved += cached_tokens
        else:
            cached_tokens = 0
            tokens = torch.tensor([prompt], dtype=torch.long, device=self.model.device)
            logits, caches = self._prefill(tokens)
            logits = logits[:1]
            pos = len(prompt)
            self.prefill_tokens_computed += len(prompt)

        # offer the *prompt* back to the cache (payload sliced to prompt)
        full_blocks = (len(prompt) // cfg.block_size) * cfg.block_size
        if full_blocks > 0:
            if self._payload_usable(len(prompt), full_blocks):
                payload = self._slice_caches(caches, full_blocks)
            else:
                payload = None  # entry still participates in admission
            self.prefix_cache.offer(prompt[:full_blocks], payload=payload)

        prompt_logits = logits[0]  # the last prompt token's, [V]
        out = [self._argmax(logits)]  # reads the logits: waits for the card
        t1 = time.perf_counter()
        for _ in range(max_new_tokens - 1):
            logits, caches = self._decode(caches, out[-1], pos)
            pos += 1
            out.append(self._argmax(logits))
        return {"tokens": out, "cached_tokens": cached_tokens, "prompt_logits": prompt_logits,
                "ttft_s": t1 - t0, "decode_s": time.perf_counter() - t1}

    def generate(self, prompts: list[list[int]], max_new_tokens: int = 8) -> list[dict]:
        return [self._run_request(p, max_new_tokens) for p in prompts]

    def serve(self, prompts: list[list[int]], max_new_tokens: int = 8) -> list[dict]:
        """Scheduler-driven serving: continuous-batching bookkeeping with
        the (B=1 tensor) execution path. Returns results in rid order."""
        for p in prompts:
            self.scheduler.submit(Request(self._rid, list(p), max_new_tokens))
            self._rid += 1
        results: dict[int, dict] = {}
        while self.scheduler.has_work:
            to_prefill, _ = self.scheduler.schedule()
            if not to_prefill:
                break  # B=1 engine: decode happens inside _run_request
            for req in to_prefill:
                r = self._run_request(req.prompt, req.max_new_tokens)
                req.cached_tokens = r["cached_tokens"]
                self.scheduler.on_prefilled(req)
                for t in r["tokens"]:
                    self.scheduler.on_token(req, t)
                results[req.rid] = r
        return [results[i] for i in sorted(results)]

    def stats(self) -> dict:
        s = self.prefix_cache.stats()
        s["prefill_tokens_computed"] = self.prefill_tokens_computed
        s["prefill_tokens_saved"] = self.prefill_tokens_saved
        total = self.prefill_tokens_computed + self.prefill_tokens_saved
        s["prefill_savings_frac"] = round(self.prefill_tokens_saved / total, 5) if total else 0.0
        return s
