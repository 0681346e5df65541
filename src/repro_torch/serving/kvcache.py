"""Paged KV-cache block pool: fixed-size token blocks, refcounting, and the
block-hash chaining used for prefix identity (vLLM-style).

The port's copy of the reference's ``repro/serving/kvcache.py``, on the
port's own ``mix64``: block hashes are equal to the reference's, bit for
bit. The pool is pure bookkeeping — the KV tensors live in the model's
dense cache trees (the engine); eviction/admission never copies KV bytes,
which is the "lightweight" property the paper targets.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.sketch import mix64

__all__ = ["BlockPool", "hash_chain", "block_hashes"]


def hash_chain(prev: int, tokens: tuple[int, ...]) -> int:
    h = prev
    for t in tokens:
        h = mix64(h * 0x100000001B3 ^ (t + 1))
    return h


_HASH_MASK = (1 << 63) - 1  # emitted hashes stay int64-representable


def block_hashes(token_ids, block_size: int) -> list[int]:
    """Rolling hash per full block of tokens (partial tail block excluded).

    The chain state is full 64-bit; emitted hashes are folded to 63 bits
    so cache keys fit the admission data planes' int64 key arrays (the
    device kernels and the sketch's batched flush both require
    int64-representable keys)."""
    out = []
    h = 0xCBF29CE484222325
    n_full = len(token_ids) // block_size
    for b in range(n_full):
        h = hash_chain(h, tuple(token_ids[b * block_size : (b + 1) * block_size]))
        out.append(h & _HASH_MASK)
    return out


@dataclasses.dataclass
class Block:
    block_id: int
    refcount: int = 0


class BlockPool:
    """Fixed-capacity block allocator with refcounting.

    ``admission`` is an optional back-pressure hook — any object with a
    ``reclaim_blocks(n) -> int`` method (the prefix cache registers
    itself). When an allocation comes up short the pool asks the hook to
    free the difference before giving up, which is how live (scheduler)
    allocations sharing the pool push cold cached prefixes out instead of
    failing."""

    def __init__(self, num_blocks: int, *, admission=None):
        self.num_blocks = num_blocks
        self.free_list: list[int] = list(range(num_blocks - 1, -1, -1))
        self.blocks: dict[int, Block] = {}
        self.admission = admission
        self.reclaims = 0  # shortage-driven reclaim_blocks calls

    @property
    def num_free(self) -> int:
        return len(self.free_list)

    @property
    def num_used(self) -> int:
        return self.num_blocks - self.num_free

    def alloc(self, n: int = 1) -> list[int] | None:
        """Allocate n blocks with refcount 1, or None if insufficient."""
        if len(self.free_list) < n and self.admission is not None:
            self.reclaims += 1
            self.admission.reclaim_blocks(n - len(self.free_list))
        if len(self.free_list) < n:
            return None
        ids = [self.free_list.pop() for _ in range(n)]
        for bid in ids:
            self.blocks[bid] = Block(bid, 1)
        return ids

    def check_invariants(self) -> None:
        """Refcount invariants: every live block has refcount >= 1, free
        and live partition the pool, no id appears twice."""
        assert len(self.free_list) == len(set(self.free_list))
        assert not set(self.free_list) & set(self.blocks)
        assert len(self.free_list) + len(self.blocks) == self.num_blocks
        for bid, b in self.blocks.items():
            assert b.refcount >= 1, f"block {bid} live with refcount {b.refcount}"

    def ref(self, block_ids) -> None:
        for bid in block_ids:
            self.blocks[bid].refcount += 1

    def unref(self, block_ids) -> None:
        for bid in block_ids:
            b = self.blocks[bid]
            b.refcount -= 1
            if b.refcount < 0:
                raise RuntimeError(f"block {bid} refcount underflow")
            if b.refcount == 0:
                del self.blocks[bid]
                self.free_list.append(bid)

    def refcount(self, bid: int) -> int:
        b = self.blocks.get(bid)
        return b.refcount if b else 0
