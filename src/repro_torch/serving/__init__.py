"""Serving substrate of the port: paged KV bookkeeping, the paper's
size-aware prefix cache, the continuous-batching scheduler, and the engine
that serves a model on the card through them."""

from .admission import AdmissionHook, SyncAdmission, make_admission_hook
from .engine import Engine, EngineConfig
from .kvcache import BlockPool, block_hashes, hash_chain
from .prefix_cache import PrefixCache, PrefixCacheConfig, kv_bytes_per_token
from .scheduler import Request, Scheduler, SchedulerConfig

__all__ = [
    "AdmissionHook",
    "SyncAdmission",
    "make_admission_hook",
    "Engine",
    "EngineConfig",
    "BlockPool",
    "block_hashes",
    "hash_chain",
    "PrefixCache",
    "PrefixCacheConfig",
    "kv_bytes_per_token",
    "Request",
    "Scheduler",
    "SchedulerConfig",
]
