"""Prefix/KV cache with size-aware W-TinyLFU admission — the paper's policy
as a first-class serving feature.

The port's counterpart of the reference's ``repro/serving/prefix_cache.py``
(synchronous admission; the reference's asynchronous pipeline is not ported
yet, see :mod:`.admission`). The policy is built through the port's own
``REGISTRY``, so spec strings such as ``wtlfu-av?sketch_backend=cms`` build
the port's policy, with its CMS kernels on the card.

Cached objects are *prompt prefixes*: variable-sized (bytes ∝ tokens x
layers x kv-heads x head-dim — differs per architecture AND per prompt),
which is exactly the regime where the paper's size-aware admission (AV/QV/
IV) beats size-oblivious policies. Hit-ratio here ⇒ prefill steps saved;
token(byte)-hit-ratio ⇒ prefill FLOPs/HBM bytes saved — the serving analogs
of the paper's two metrics.

Mechanics:
* identity: rolling block-hash chain over the prompt (kvcache.block_hashes);
* lookup: longest cached prefix (walk the chain, deepest hash wins);
* offer: a finished request's prompt becomes a cache *candidate object*
  whose size is its KV byte footprint; the admission policy (the paper's
  core loop) decides whether it displaces resident prefixes;
* physical blocks are refcounted in a BlockPool; policy-level eviction
  releases block references. Policy capacity is clamped to the pool's
  whole-block bytes, so entry materialization can never exhaust the pool
  the policy said had room;
* a shortage in the pool reclaims resident prefixes in the eviction
  policy's own victim order (``reclaim_victims`` + ``discard``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core import REGISTRY, PolicySpec

from .admission import AdmissionHook, make_admission_hook
from .kvcache import BlockPool, block_hashes

__all__ = ["PrefixCacheConfig", "PrefixCache", "kv_bytes_per_token"]


def kv_bytes_per_token(cfg, dtype_bytes: int = 2) -> int:
    """Per-token KV bytes for an architecture (the object-size model).

    MLA caches latents (kv_lora+rope); attention-free archs have O(1)
    state (degenerate case)."""
    if cfg.use_mla:
        per_layer = cfg.kv_lora_rank + cfg.qk_rope_dim
        n_layers = cfg.num_layers
        return n_layers * per_layer * dtype_bytes
    total = 0
    for seg in cfg.layer_plan():
        for kind in seg.kinds:
            if kind in ("dense", "dense_local", "moe", "dec", "enc"):
                total += seg.repeat * 2 * cfg.num_kv_heads * cfg.resolved_head_dim
    return max(total, 2 * cfg.d_model) * dtype_bytes


@dataclasses.dataclass(frozen=True)
class PrefixCacheConfig:
    capacity_bytes: int
    block_size: int = 16  # tokens per block
    bytes_per_token: int = 2 * 32 * 128 * 2  # overridden per arch
    policy: str = "wtlfu-av"  # any repro_torch.core registry spec string
    policy_kwargs: dict | None = None
    admission: str = "sync"  # "async" is not ported yet
    #: extra physical blocks beyond the policy's capacity — headroom for
    #: live (scheduler) allocations sharing the pool, so steady-state
    #: decode traffic doesn't cannibalize the cache; only demand past the
    #: headroom reclaims cached prefixes
    pool_headroom_blocks: int = 0


@dataclasses.dataclass
class _Entry:
    key: int  # final block hash
    n_blocks: int
    hashes: list[int]
    block_ids: list[int]
    payload: Any = None  # optional KV tensors (the engine's)


class PrefixCache:
    def __init__(self, config: PrefixCacheConfig,
                 admission: "AdmissionHook | None" = None):
        self.cfg = config
        block_bytes = config.block_size * config.bytes_per_token
        num_blocks = max(1, config.capacity_bytes // block_bytes)
        self.pool = BlockPool(num_blocks + config.pool_headroom_blocks,
                              admission=self)
        self.block_bytes = block_bytes
        spec = PolicySpec.parse(config.policy)
        kw = dict(config.policy_kwargs or {})
        if (
            spec.name.startswith("wtlfu")
            and "expected_entries" not in kw
            and "expected_entries" not in spec.params_dict
        ):
            kw["expected_entries"] = max(64, num_blocks)
        # clamp the policy to whole-block bytes: the policy then can never
        # keep more resident bytes than the pool has physical blocks, so a
        # policy-admitted entry always materializes
        self.policy = REGISTRY.build(spec, num_blocks * block_bytes, **kw)
        self.admission: AdmissionHook = admission or make_admission_hook(
            self.policy, config.admission)
        self.entries: dict[int, _Entry] = {}
        self.by_hash: dict[int, list[int]] = {}  # block hash -> entry keys
        self._reclaiming = False
        # serving metrics (paper analogs)
        self.requests = 0
        self.requests_with_hit = 0
        self.tokens_requested = 0
        self.tokens_hit = 0
        self.blocks_requested = 0  # cacheable (full) blocks asked for
        self.blocks_hit = 0
        self.stale_rewalks = 0  # lookups corrected by the residency guard

    # -- internal: keep policy and physical pool in sync -------------------
    def _drop(self, key: int) -> "_Entry | None":
        """Remove ``key``'s entry from the view and release its blocks."""
        e = self.entries.pop(key, None)
        if e is None:
            return None
        self.pool.unref(e.block_ids)
        for h in e.hashes:
            lst = self.by_hash.get(h)
            if lst is not None:
                lst.remove(key)
                if not lst:
                    del self.by_hash[h]
        return e

    def _sync_evictions(self) -> None:
        for k in [k for k in self.entries if k not in self.policy]:
            self._drop(k)

    def _walk(self, hashes) -> tuple[int, "_Entry | None"]:
        depth = 0
        entry = None
        for i, h in enumerate(hashes):
            keys = self.by_hash.get(h)
            if not keys:
                break
            depth = i + 1
            entry = self.entries[keys[0]]
        return depth, entry

    def _materialize(self, key: int, hashes: list[int], payload) -> bool:
        if key in self.entries:
            if payload is not None:
                self.entries[key].payload = payload
            return True
        block_ids = self.pool.alloc(len(hashes))
        if block_ids is None:
            # physical pool exhausted (only reachable when live scheduler
            # allocations share the pool) — give up; the policy keeps a
            # ghost whose bytes age out through normal eviction
            return False
        e = _Entry(key, len(hashes), hashes, block_ids, payload)
        self.entries[key] = e
        for h in hashes:
            self.by_hash.setdefault(h, []).append(key)
        return True

    # -- BlockPool admission hook (shared-pool reclaim) ---------------------
    def _reclaim_order(self, n: int):
        """Resident entry keys in shortage-reclaim order: the eviction
        policy's own victim ranking first (``reclaim_victims``, with the
        byte shortage as sizing context), then any residents the policy's
        bounded victim walk did not reach, oldest materialized first."""
        victims = getattr(self.policy, "reclaim_victims", None)
        order: list[int] = []
        ranked = set()
        if victims is not None:
            # materialize BEFORE discarding anything: the ranking walks the
            # policy's live structures, which each discard mutates
            for key in victims(n * self.block_bytes):
                if key in self.entries and key not in ranked:
                    ranked.add(key)
                    order.append(key)
        order.extend(k for k in self.entries if k not in ranked)
        return order

    def reclaim_blocks(self, n: int) -> int:
        """Free up to ``n`` blocks by force-evicting resident entries in
        the eviction policy's victim order. Called by the pool's admission
        hook when a live (scheduler) allocation comes up short. Returns
        the number of blocks actually freed; a nested call reports 0 freed
        blocks and leaves all accounting to the outer call."""
        if self._reclaiming:
            return 0
        self._reclaiming = True
        try:
            self._sync_evictions()
            freed = 0
            discard = getattr(self.policy, "discard", None)
            for key in self._reclaim_order(n):
                if freed >= n:
                    break
                e = self._drop(key)
                if e is None:
                    continue  # a nested path raced this key away
                if discard is not None:
                    discard(key)  # keep policy byte-accounting honest
                freed += e.n_blocks
            return freed
        finally:
            self._reclaiming = False

    # -- API -----------------------------------------------------------------
    def lookup(self, token_ids) -> tuple[int, "_Entry | None"]:
        """Longest-prefix match. Returns (n_cached_tokens, entry). Counts a
        policy access for the matched entry (a hit 'touches' the object)."""
        self.requests += 1
        self.tokens_requested += len(token_ids)
        hashes = block_hashes(token_ids, self.cfg.block_size)
        self.blocks_requested += len(hashes)
        depth, entry = self._walk(hashes)
        while entry is not None and entry.key not in self.policy:
            # residency guard: the policy dropped this entry but the view
            # was not yet synced (the policy driven outside this cache) —
            # never serve a stale entry
            self.stale_rewalks += 1
            self._sync_evictions()
            depth, entry = self._walk(hashes)
        if entry is None:
            return 0, None
        n_tokens = depth * self.cfg.block_size
        self.requests_with_hit += 1
        self.tokens_hit += n_tokens
        self.blocks_hit += depth
        # policy sees an access to the *matched* entry
        self.admission.touch(entry.key, entry.n_blocks * self.block_bytes)
        self._sync_evictions()
        return n_tokens, entry

    def offer(self, token_ids, payload: Any = None) -> bool:
        """Offer a finished prompt as a cache candidate (the paper's
        admission decision). Returns True if (newly or already) resident."""
        hashes = block_hashes(token_ids, self.cfg.block_size)
        if not hashes:
            return False
        key = hashes[-1]
        self.admission.offer(key, len(hashes) * self.block_bytes)
        self._sync_evictions()
        if key not in self.policy:
            return False  # rejected by admission
        return self._materialize(key, hashes, payload)

    def sync(self) -> None:
        """Bring the view in line with the policy's residency."""
        self._sync_evictions()

    # -- stats -----------------------------------------------------------------
    @property
    def request_hit_ratio(self) -> float:
        return self.requests_with_hit / self.requests if self.requests else 0.0

    @property
    def token_hit_ratio(self) -> float:
        """Fraction of prompt tokens served from cache = prefill compute
        saved (the byte-hit-ratio analog)."""
        return self.tokens_hit / self.tokens_requested if self.tokens_requested else 0.0

    @property
    def byte_hit_ratio(self) -> float:
        """Fraction of *cacheable* KV bytes served from cache: full-block
        bytes only (partial tail blocks are never cacheable), so this is
        the HBM-bytes analog of the paper's byte hit ratio and differs
        from the token ratio, whose denominator counts every prompt
        token."""
        return (self.blocks_hit / self.blocks_requested
                if self.blocks_requested else 0.0)

    def stats(self) -> dict:
        self._sync_evictions()
        out = {
            "requests": self.requests,
            "request_hit_ratio": round(self.request_hit_ratio, 5),
            "token_hit_ratio": round(self.token_hit_ratio, 5),
            "byte_hit_ratio": round(self.byte_hit_ratio, 5),
            "entries": len(self.entries),
            "blocks_used": self.pool.num_used,
            "blocks_total": self.pool.num_blocks,
            "policy": self.cfg.policy,
            "stale_rewalks": self.stale_rewalks,
        }
        metrics = getattr(self.admission, "metrics", None)
        if metrics is not None:
            out["admission"] = metrics()
        return out
