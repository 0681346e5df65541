"""Core cache policy API: traces, stats, and the policy protocol.

Every policy implements :class:`CachePolicy` and is driven over a trace of
``(key, size)`` accesses by :class:`repro_torch.core.engine.SimulationEngine`,
producing hit-ratio, byte-hit-ratio and overhead statistics (the paper's
Section 5 instrument).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Protocol

import numpy as np

__all__ = [
    "AccessTrace",
    "CacheStats",
    "CachePolicy",
]


@dataclasses.dataclass(frozen=True)
class AccessTrace:
    """A sequence of object accesses: parallel arrays of keys and byte sizes."""

    name: str
    keys: np.ndarray  # int64 object ids
    sizes: np.ndarray  # int64 object sizes in bytes

    def __post_init__(self):
        if self.keys.shape != self.sizes.shape:
            raise ValueError("keys and sizes must be parallel arrays")

    def __len__(self) -> int:
        return int(self.keys.shape[0])

    @property
    def num_objects(self) -> int:
        return int(np.unique(self.keys).size)

    @property
    def total_object_bytes(self) -> int:
        """Total size of unique objects (paper Table 1, 'Total Objects Size')."""
        _, first_idx = np.unique(self.keys, return_index=True)
        return int(self.sizes[first_idx].sum())

    @property
    def mean_object_size(self) -> float:
        _, first_idx = np.unique(self.keys, return_index=True)
        return float(self.sizes[first_idx].mean())

    def slice(self, n: int) -> "AccessTrace":
        return AccessTrace(self.name, self.keys[:n], self.sizes[:n])

    def iter_chunks(self, chunk_size: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Stream ``(keys, sizes)`` array views of at most ``chunk_size``
        accesses — O(chunk) memory regardless of trace length."""
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        n = len(self)
        for lo in range(0, n, chunk_size):
            hi = min(lo + chunk_size, n)
            yield self.keys[lo:hi], self.sizes[lo:hi]


@dataclasses.dataclass
class CacheStats:
    """Hit/byte-hit accounting (paper Section 1: hit-ratio vs byte-hit-ratio)."""

    accesses: int = 0
    hits: int = 0
    bytes_requested: int = 0
    bytes_hit: int = 0
    # Victim bookkeeping for the early-pruning study (paper Fig. 7).
    victims_examined: int = 0
    admissions: int = 0
    rejections: int = 0
    evictions: int = 0
    wall_seconds: float = 0.0

    @property
    def misses(self) -> int:
        return self.accesses - self.hits

    @property
    def hit_ratio(self) -> float:
        return self.hits / self.accesses if self.accesses else 0.0

    @property
    def byte_hit_ratio(self) -> float:
        return self.bytes_hit / self.bytes_requested if self.bytes_requested else 0.0

    @property
    def victims_per_access(self) -> float:
        return self.victims_examined / self.accesses if self.accesses else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_ratio"] = self.hit_ratio
        d["byte_hit_ratio"] = self.byte_hit_ratio
        d["victims_per_access"] = self.victims_per_access
        return d


class CachePolicy(Protocol):
    """A size-aware cache management policy.

    ``access`` is the single hot-path entry point: record an access to
    ``key`` of ``size`` bytes and return True on a cache hit.

    Policies may additionally define an *optional* ``access_batch(keys,
    sizes) -> bool ndarray`` fast path (deliberately not part of this
    protocol — the engine probes for it and falls back to a scalar loop):
    drive a whole chunk of parallel key/size arrays and return a hit mask.
    Implementations must be observationally identical to the scalar loop —
    the method exists so policies can amortize per-access overhead (e.g.
    W-TinyLFU batching its sketch traffic through the CMS kernels).
    """

    capacity: int
    stats: CacheStats

    def access(self, key: int, size: int) -> bool:  # pragma: no cover - protocol
        ...

    def used_bytes(self) -> int:  # pragma: no cover - protocol
        ...

    def __contains__(self, key: int) -> bool:  # pragma: no cover - protocol
        ...

