"""The port's serving stack against the reference's.

Mirrors tests/test_serving.py (block pool, block hashes, prefix cache,
scheduler, engine) and the shared-pool reclaim of
tests/test_serving_admission.py on the port, and holds the port against
the reference on the same inputs. Every compared path here is integer and
compared exactly: block hashes, cache contents and stats, policy state,
the reclaim's victim order, generated tokens and cached-token counts. The
engines' admission-latency percentiles are wall-clock times and are left
out of the comparison of their stats. One float comparison: a cached
prefix's last prompt token logits (the decode path) against a cold
prefill's, float32 atol = rtol = 1e-5 (another order of summation).

RWKV-6 (``rwkv6-7b`` scaled down) serves block-aligned traffic, where a
bare template stores its final recurrent state and a later request decodes
only its suffix from it. Its tests cover the engine's recurrent rules
(a state is stored only for a block-aligned prompt, whole, and a hit's
decode leaves it as it was) and two faults of the reference that the port
mirrors (ROADMAP §3): a fully cached block-aligned prompt re-applies its
last token, and a lookup that stops inside a longer entry takes that
entry's whole-prompt state. A mirrored fault shows as logits that differ
from a cold prefill's by more than 1e-3 while the port's tokens equal the
reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import fast_jax_cms, policy_state, torch_one_thread  # noqa: F401

from repro.configs import get_config as jax_get_config
from repro.models import LM as JaxLM
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import PrefixCache as JaxPrefixCache
from repro.serving import PrefixCacheConfig as JaxPrefixCacheConfig
from repro.serving import block_hashes as jax_block_hashes
from repro.serving import kv_bytes_per_token as jax_kv_bytes_per_token
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import LM, params_from_jax
from repro_torch.serving import (
    BlockPool,
    Engine,
    EngineConfig,
    PrefixCache,
    PrefixCacheConfig,
    Request,
    Scheduler,
    SchedulerConfig,
    block_hashes,
    kv_bytes_per_token,
    make_admission_hook,
)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


# -- block pool and hashes -------------------------------------------------------
class TestBlockPool:
    def test_alloc_free_cycle(self):
        pool = BlockPool(4)
        ids = pool.alloc(3)
        assert len(ids) == 3 and pool.num_free == 1
        assert pool.alloc(2) is None  # insufficient
        pool.unref(ids[:2])
        assert pool.num_free == 3

    def test_refcount_sharing(self):
        pool = BlockPool(2)
        (bid,) = pool.alloc(1)
        pool.ref([bid])
        pool.unref([bid])
        assert pool.refcount(bid) == 1
        pool.unref([bid])
        assert pool.num_free == 2

    def test_underflow_raises(self):
        pool = BlockPool(1)
        (bid,) = pool.alloc(1)
        pool.unref([bid])
        with pytest.raises(Exception):
            pool.unref([bid])

    @pytest.mark.parametrize("seed", range(3))
    def test_never_leaks_or_double_frees(self, seed):
        rng = np.random.default_rng(seed)
        pool = BlockPool(8)
        live = []
        for _ in range(60):
            if rng.random() < 0.5:
                got = pool.alloc(1)
                if got is not None:
                    live.extend(got)
            elif live:
                pool.unref([live.pop()])
            pool.check_invariants()
        assert pool.num_used == len(live)
        assert pool.num_free + pool.num_used == 8


class TestBlockHashes:
    def test_prefix_property(self):
        a = block_hashes([1, 2, 3, 4, 5, 6, 7, 8], 4)
        b = block_hashes([1, 2, 3, 4, 9, 9, 9, 9], 4)
        assert a[0] == b[0] and a[1] != b[1]

    def test_partial_block_excluded(self):
        assert len(block_hashes([1, 2, 3], 4)) == 0
        assert len(block_hashes([1, 2, 3, 4, 5], 4)) == 1

    def test_chain_depends_on_history(self):
        a = block_hashes([1, 2, 3, 4], 2)
        b = block_hashes([9, 9, 3, 4], 2)
        assert a[1] != b[1]  # same block tokens, different history

    @pytest.mark.parametrize("block_size", [1, 4, 16])
    def test_equal_to_reference(self, block_size):
        rng = np.random.default_rng(block_size)
        for n in (0, 3, 16, 97, 300):
            tokens = [int(t) for t in rng.integers(0, 49152, n)]
            assert block_hashes(tokens, block_size) == jax_block_hashes(tokens, block_size)


# -- prefix cache -----------------------------------------------------------------
def make_cache(policy="wtlfu-av", capacity_blocks=16, block_size=4, bpt=10, headroom=0,
               reference=False):
    cls, cfg_cls = (JaxPrefixCache, JaxPrefixCacheConfig) if reference else (
        PrefixCache, PrefixCacheConfig)
    return cls(cfg_cls(
        capacity_bytes=capacity_blocks * block_size * bpt, block_size=block_size,
        bytes_per_token=bpt, policy=policy, pool_headroom_blocks=headroom,
        **({} if reference else {"policy_kwargs": {"device": "cpu"}})))


def drive(cache, n=300, seed=0, key_space=12):
    """Zipf-reused template stream: lookup (with unique suffix) + offer."""
    rng = np.random.default_rng(seed)
    hits = []
    for i in range(n):
        base = int((rng.zipf(1.3) - 1) % key_space)
        length = (1 + base % 4) * cache.cfg.block_size
        prompt = [base * 1000 + j for j in range(length)]
        hits.append(cache.lookup(prompt + [10**6 + i])[0])
        cache.offer(prompt)
    cache.sync()
    return hits


def _cache_view(c):
    stats = c.stats()
    stats.pop("admission")  # wall-clock decision latencies
    return stats, list(c.entries), {k: e.block_ids for k, e in c.entries.items()}


class TestPrefixCache:
    def test_miss_then_hit(self):
        c = make_cache()
        prompt = list(range(16))
        n, e = c.lookup(prompt)
        assert n == 0 and e is None
        assert c.offer(prompt)
        n, e = c.lookup(prompt)
        assert n == 16 and e is not None

    def test_longest_prefix_match(self):
        c = make_cache()
        c.offer(list(range(8)))  # 2 blocks
        n, _ = c.lookup(list(range(8)) + [99, 98, 97, 96])
        assert n == 8

    def test_diverging_prefix_no_match(self):
        c = make_cache()
        c.offer(list(range(8)))
        n, e = c.lookup([7, 6, 5, 4, 3, 2, 1, 0])
        assert n == 0 and e is None

    def test_eviction_frees_blocks(self):
        c = make_cache(capacity_blocks=8, block_size=4)
        for i in range(20):  # each entry = 2 blocks; pool holds 8
            c.offer([i * 100 + j for j in range(8)])
        assert c.pool.num_used <= c.pool.num_blocks
        for k in c.entries:
            assert k in c.policy

    def test_hot_prefix_survives_scans(self):
        """TinyLFU's raison d'etre: a scan of one-off prefixes must not
        evict the hot prefix."""
        c = make_cache(capacity_blocks=12, block_size=4)
        hot = list(range(16))
        for _ in range(30):
            c.lookup(hot)
            c.offer(hot)
        for i in range(50):
            cold = [10_000 + i * 100 + j for j in range(16)]
            c.lookup(cold)
            c.offer(cold)
        assert c.lookup(hot)[0] == 16, "AV evicted the hot prefix"

    @pytest.mark.parametrize("policy", [
        "wtlfu-av", "wtlfu-qv", "wtlfu-iv", "wtlfu-av-sampled_frequency",
        "wtlfu-qv-lru?sketch_backend=cms"])
    def test_equal_to_reference(self, policy):
        """The same stream through both packages' caches: every lookup's
        depth, the stats, the resident entries with their block ids, and
        the policy's whole state are equal."""
        a, b = make_cache(policy=policy), make_cache(policy=policy, reference=True)
        if "cms" in policy:
            fast_jax_cms(b.policy.sketch)  # the reference's sketch, jitted (see _torch_port)
        assert drive(a) == drive(b)
        assert _cache_view(a) == _cache_view(b)
        assert a.policy.stats.as_dict().keys() == b.policy.stats.as_dict().keys()
        sa, sb = policy_state(a.policy), policy_state(b.policy)
        for k in sa:
            assert np.array_equal(sa[k], sb[k]) if isinstance(sa[k], np.ndarray) else sa[k] == sb[k], k

    def test_kv_bytes_per_token_equal_to_reference(self):
        for arch in ARCHS:
            for dtype_bytes in (2, 4):
                assert kv_bytes_per_token(get_config(arch), dtype_bytes) == \
                    jax_kv_bytes_per_token(jax_get_config(arch), dtype_bytes)

    def test_async_admission_is_not_ported(self):
        with pytest.raises(NotImplementedError, match="item 6"):
            PrefixCache(PrefixCacheConfig(capacity_bytes=640, block_size=4, bytes_per_token=10,
                                          admission="async", policy_kwargs={"device": "cpu"}))
        with pytest.raises(ValueError):
            make_admission_hook(None, "later")


# -- shared-pool reclaim ------------------------------------------------------------
class TestReclaim:
    def _filled(self, reference, policy="wtlfu-av"):
        c = make_cache(policy=policy, capacity_blocks=8, block_size=4, reference=reference)
        prompts = [[i * 100 + j for j in range(8)] for i in range(3)]
        for p in prompts:
            assert c.offer(p)  # 2 blocks each; FIFO order 0, 1, 2
        assert c.lookup(prompts[0])[0] == 8  # the oldest is touched
        return c

    @pytest.mark.parametrize("policy", ["wtlfu-av", "wtlfu-av-sampled_frequency",
                                        "wtlfu-qv-random"])
    def test_victim_order_and_discards_equal_to_reference(self, policy):
        """``reclaim_victims`` ranks residents as the reference does, and a
        shortage reclaim discards the same entries."""
        a, b = self._filled(False, policy), self._filled(True, policy)
        ranked = list(a.policy.reclaim_victims(2 * a.block_bytes))
        assert ranked == list(b.policy.reclaim_victims(2 * b.block_bytes))
        if policy == "wtlfu-av":  # SLRU: the touched oldest goes last
            assert ranked[-1] == next(iter(a.entries))
        got_a, got_b = a.pool.alloc(5), b.pool.alloc(5)  # shortage: reclaims two entries
        assert got_a == got_b and a.pool.reclaims == b.pool.reclaims == 1
        assert _cache_view(a) == _cache_view(b)
        assert a.policy.stats.as_dict() == b.policy.stats.as_dict()
        assert a.policy.used_bytes() == sum(e.n_blocks * a.block_bytes for e in a.entries.values())
        a.pool.check_invariants()

    def test_discard(self):
        c = self._filled(False)
        key = next(iter(c.entries))
        evictions = c.policy.stats.evictions
        assert c.policy.discard(key) and key not in c.policy
        assert not c.policy.discard(key)
        assert c.policy.stats.evictions == evictions + 1

    def test_nested_reclaim_reports_zero(self):
        c = make_cache(capacity_blocks=8, block_size=4)
        for i in range(3):
            assert c.offer([i * 100 + j for j in range(8)])
        nested: list[int] = []
        orig_discard = c.policy.discard

        def reentrant_discard(key):
            nested.append(c.reclaim_blocks(4))  # re-entry mid-reclaim
            return orig_discard(key)

        c.policy.discard = reentrant_discard
        freed = c.reclaim_blocks(2)
        c.policy.discard = orig_discard
        assert nested and all(v == 0 for v in nested), nested
        assert freed >= 2
        assert c.policy.used_bytes() == sum(e.n_blocks * c.block_bytes for e in c.entries.values())
        c.pool.check_invariants()

    def test_headroom_blocks_extend_pool_not_policy(self):
        flat = make_cache(capacity_blocks=8, block_size=4)
        roomy = make_cache(capacity_blocks=8, block_size=4, headroom=5)
        assert roomy.pool.num_blocks == flat.pool.num_blocks + 5
        assert roomy.policy.capacity == flat.policy.capacity


# -- scheduler ----------------------------------------------------------------------
class TestScheduler:
    def test_prefill_budget_and_slots(self):
        s = Scheduler(SchedulerConfig(max_running=2, prefill_token_budget=10))
        for i in range(4):
            s.submit(Request(i, list(range(6)), 2))
        pf, _ = s.schedule()
        assert len(pf) == 1
        for r in pf:
            s.on_prefilled(r)
        pf2, dec = s.schedule()
        assert len(pf2) == 1 and len(dec) == 1

    def test_completion_flow(self):
        s = Scheduler(SchedulerConfig())
        r = Request(0, [1, 2, 3], 2)
        s.submit(r)
        pf, _ = s.schedule()
        s.on_prefilled(pf[0])
        s.on_token(r, 7)
        assert not r.done
        s.on_token(r, 8)
        assert r.done and r in s.finished and not s.has_work

    def test_preemption_resets(self):
        s = Scheduler(SchedulerConfig())
        r = Request(0, [1, 2, 3, 4], 4)
        s.submit(r)
        s.schedule()
        s.on_prefilled(r)
        s.on_token(r, 5)
        s.preempt(r)
        assert r.state == "waiting" and r.generated == [] and r.preemptions == 1
        assert s.waiting[0] is r

    def test_preemption_storm_never_leaks(self):
        pool = BlockPool(6)
        sched = Scheduler(SchedulerConfig(max_running=2), pool=pool, block_size=4)
        for i in range(4):
            sched.submit(Request(i, list(range(6)), 2))
        rng = np.random.default_rng(3)
        for _ in range(200):
            for r in sched.schedule()[0]:
                sched.on_prefilled(r)
            if sched.running and rng.random() < 0.3:
                sched.preempt(sched.running[-1])
            for r in list(sched.running):
                sched.on_token(r, 0)
            pool.check_invariants()
            if not sched.has_work:
                break
        assert not sched.has_work
        assert pool.num_used == 0 and len(sched.finished) == 4


# -- engine ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engine_parts():
    """2-layer SmolLM-135M, gemma2-27b and rwkv6-7b of the reference, their
    parameters carried over."""
    out = {}
    for arch in ("smollm-135m", "gemma2-27b", "rwkv6-7b"):
        jm = JaxLM(jax_get_config(arch).scaled_down(num_layers=2), dtype=jnp.float32,
                   remat=False)
        jp = jax.jit(jm.init)(jax.random.key(0))
        pm = LM(get_config(arch).scaled_down(num_layers=2), device="cpu")
        out[arch] = (jm, jp, pm, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def _prompts(vocab, seed=1, n=8):
    """Two shared templates (24 and 16 tokens) with 4-token suffixes."""
    rng = np.random.default_rng(seed)
    templates = [[int(x) for x in rng.integers(0, vocab, m)] for m in (24, 16)]
    return [templates[int(rng.integers(0, 2))] + [int(x) for x in rng.integers(0, vocab, 4)]
            for _ in range(n)]


def _aligned_prompts(vocab, block, seed=2, n=16):
    """Phase 6's traffic at small lengths: three templates of whole blocks
    (2-4 of ``block`` tokens), each request a Zipf(1.2) choice of template;
    request i is the bare template when ``i % 4 == 0``, else the template
    plus 4 random tokens."""
    rng = np.random.default_rng(seed)
    templates = [[int(x) for x in rng.integers(0, vocab, block * int(m))]
                 for m in rng.integers(2, 5, 3)]
    pmf = np.arange(1, 4.0) ** -1.2
    pmf /= pmf.sum()
    out = []
    for i in range(n):
        t = templates[int(rng.choice(3, p=pmf))]
        out.append(t if i % 4 == 0 else t + [int(x) for x in rng.integers(0, vocab, 4)])
    return out


def _engine_stats(eng):
    s = eng.stats()
    s["admission"] = {k: v for k, v in s["admission"].items() if not k.startswith("decision_")}
    return s


class TestEngine:
    ECFG = {"max_seq": 64, "cache_capacity_bytes": 1 << 22, "block_size": 8}

    @pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-27b"])
    def test_serve_equal_to_reference(self, engine_parts, arch):
        """Both engines serve the same prompts on the same parameters:
        tokens, cached tokens and stats are equal. gemma2's windowed layers
        (window 32) decode past their window from a cached prefix."""
        jm, jp, pm, pp = engine_parts[arch]
        prompts = _prompts(pm.cfg.vocab_size)
        jax_eng = JaxEngine(jm, jp, JaxEngineConfig(cache_policy="wtlfu-av", **self.ECFG))
        eng = Engine(pm, pp, EngineConfig(cache_policy="wtlfu-av", **self.ECFG))
        want = jax_eng.serve(prompts, max_new_tokens=8)
        got = eng.serve(prompts, max_new_tokens=8)
        assert [r["tokens"] for r in got] == [r["tokens"] for r in want]
        assert [r["cached_tokens"] for r in got] == [r["cached_tokens"] for r in want]
        assert any(r["cached_tokens"] > 0 for r in got)
        assert _engine_stats(eng) == _engine_stats(jax_eng)

    def test_rwkv_serve_equal_to_reference(self, engine_parts):
        """Block-aligned traffic through 2-layer rwkv6-7b: requests decode
        their suffix from a stored recurrent state; tokens, cached tokens
        and stats equal the reference engine's."""
        jm, jp, pm, pp = engine_parts["rwkv6-7b"]
        prompts = _aligned_prompts(pm.cfg.vocab_size, self.ECFG["block_size"])
        spec = "wtlfu-av?sketch_backend=cms"
        jax_eng = JaxEngine(jm, jp, JaxEngineConfig(cache_policy=spec, **self.ECFG))
        fast_jax_cms(jax_eng.prefix_cache.policy.sketch)
        eng = Engine(pm, pp, EngineConfig(cache_policy=spec, **self.ECFG))
        want = jax_eng.serve(prompts, max_new_tokens=6)
        got = eng.serve(prompts, max_new_tokens=6)
        assert [r["tokens"] for r in got] == [r["tokens"] for r in want]
        assert [r["cached_tokens"] for r in got] == [r["cached_tokens"] for r in want]
        assert any(r["cached_tokens"] > 0 and len(p) % 8 for r, p in zip(got, prompts))
        assert _engine_stats(eng) == _engine_stats(jax_eng)
        assert eng.prefill_tokens_saved > 0

    def test_rwkv_state_needs_a_block_aligned_prompt(self, engine_parts):
        """A prompt that ends inside a block offers its whole blocks to the
        cache but stores no state: the state after the whole prompt is not
        the state after its blocks."""
        _, _, pm, pp = engine_parts["rwkv6-7b"]
        eng = Engine(pm, pp, EngineConfig(**self.ECFG))
        eng.generate([list(range(20))], max_new_tokens=2)
        (entry,) = eng.prefix_cache.entries.values()
        assert entry.n_blocks == 2 and entry.payload is None

    def test_rwkv_state_is_stored_whole(self, engine_parts):
        """A block-aligned prompt stores each layer's state after the prompt
        whole (no leaf cut on axis 2), as copies: equal to a cold prefill's
        caches although the request decoded two more tokens after it."""
        _, _, pm, pp = engine_parts["rwkv6-7b"]
        eng = Engine(pm, pp, EngineConfig(**self.ECFG))
        prompt = list(range(16))
        eng.generate([prompt], max_new_tokens=3)
        (entry,) = eng.prefix_cache.entries.values()
        with torch.inference_mode():
            _, caches = pm.prefill(pp, {"tokens": torch.tensor([prompt])}, max_seq=64)
        for seg_got, seg_want in zip(entry.payload, caches):
            for key in seg_want:
                assert seg_got[key].keys() == seg_want[key].keys() == {"S", "tm_prev", "cm_prev"}
                for name, want in seg_want[key].items():
                    assert seg_got[key][name].shape == want.shape, name
                    torch.testing.assert_close(seg_got[key][name], want, atol=0, rtol=0)

    def test_rwkv_hit_decode_leaves_the_stored_state_unchanged(self, engine_parts):
        """The port decodes in place: a hit decodes from a copy of the
        stored state, which stays as it was."""
        _, _, pm, pp = engine_parts["rwkv6-7b"]
        eng = Engine(pm, pp, EngineConfig(**self.ECFG))
        prompt = list(range(16))
        eng.generate([prompt], max_new_tokens=2)
        (entry,) = eng.prefix_cache.entries.values()
        before = [{k: {n: t.clone() for n, t in c.items()} for k, c in seg.items()}
                  for seg in entry.payload]
        (out,) = eng.generate([prompt + [5, 6, 7, 8]], max_new_tokens=4)
        assert out["cached_tokens"] == 16
        for seg_now, seg_before in zip(entry.payload, before):
            for key in seg_before:
                for name, t in seg_before[key].items():
                    assert torch.equal(seg_now[key][name], t), (key, name)

    def _mirrored_fault(self, engine_parts, first, second):
        """Serve ``first`` then ``second`` on the port's and the reference's
        engines, and ``second`` on a cold port engine; returns (the port's
        second result, the cold result)."""
        jm, jp, pm, pp = engine_parts["rwkv6-7b"]
        jax_eng = JaxEngine(jm, jp, JaxEngineConfig(**self.ECFG))
        eng, cold = Engine(pm, pp, EngineConfig(**self.ECFG)), Engine(pm, pp, EngineConfig(**self.ECFG))
        want = jax_eng.generate([first, second], max_new_tokens=4)
        got = eng.generate([first, second], max_new_tokens=4)
        assert [r["tokens"] for r in got] == [r["tokens"] for r in want]
        assert [r["cached_tokens"] for r in got] == [r["cached_tokens"] for r in want]
        (ref,) = cold.generate([second], max_new_tokens=4)
        return got[1], ref

    def test_rwkv_mirrors_reference_fault_fully_cached_prompt_reapplies_last_token(self, engine_parts):
        """ROADMAP §3 (a): a fully cached block-aligned prompt is looked up
        at len - 1 tokens and its last token decoded again from a state that
        already holds it, so the logits differ from a cold prefill's. The
        port mirrors the reference."""
        prompt = [int(x) for x in np.random.default_rng(3).integers(0, 512, 16)]
        hit, cold = self._mirrored_fault(engine_parts, prompt, prompt)
        assert hit["cached_tokens"] == 15
        assert float((hit["prompt_logits"] - cold["prompt_logits"]).abs().max()) > 1e-3

    def test_rwkv_mirrors_reference_fault_walk_stops_inside_a_longer_entry(self, engine_parts):
        """ROADMAP §3 (b): a prompt that shares only the first two blocks of
        a stored 4-block entry is looked up at those blocks and handed that
        entry's state after all 4, so the logits differ from a cold
        prefill's. The port mirrors the reference."""
        rng = np.random.default_rng(4)
        stored = [int(x) for x in rng.integers(0, 512, 32)]
        shorter = stored[:16] + [int(x) for x in rng.integers(0, 512, 5)]
        hit, cold = self._mirrored_fault(engine_parts, stored, shorter)
        assert hit["cached_tokens"] == 16
        assert float((hit["prompt_logits"] - cold["prompt_logits"]).abs().max()) > 1e-3

    def test_dense_mirrors_reference_fully_cached_prompt_clamps_last_slot(self, engine_parts):
        """ROADMAP §3 F2 for attention kinds: a fully cached block-aligned
        prompt's stored KV holds all its tokens but is looked up at one
        fewer, so it is not re-padded to max_seq, and decoding writes past
        its end. The reference's ``dynamic_update_slice`` clamps the write
        into the last slot; the port clamps it the same way, so both
        engines give the same tokens."""
        jm, jp, pm, pp = engine_parts["smollm-135m"]
        prompt = list(range(16))
        want = JaxEngine(jm, jp, JaxEngineConfig(**self.ECFG)).generate([prompt, prompt],
                                                                         max_new_tokens=4)
        got = Engine(pm, pp, EngineConfig(**self.ECFG)).generate([prompt, prompt],
                                                                 max_new_tokens=4)
        assert want[1]["cached_tokens"] == 15
        assert [r["cached_tokens"] for r in got] == [r["cached_tokens"] for r in want]
        assert [r["tokens"] for r in got] == [r["tokens"] for r in want]

    def test_cached_equals_uncached(self, engine_parts):
        _, _, pm, pp = engine_parts["smollm-135m"]
        rng = np.random.default_rng(1)
        shared = [int(x) for x in rng.integers(0, pm.cfg.vocab_size, 24)]
        prompts = [shared + [int(x) for x in rng.integers(0, pm.cfg.vocab_size, 4)]
                   for _ in range(3)]
        cfg = EngineConfig(cache_policy="wtlfu-av?sketch_backend=cms", **self.ECFG)
        cold, warm = Engine(pm, pp, cfg), Engine(pm, pp, cfg)
        warm.generate([shared], max_new_tokens=2)
        out_cold = cold.generate(prompts, max_new_tokens=6)
        out_warm = warm.generate(prompts, max_new_tokens=6)
        for a, b in zip(out_cold, out_warm):
            assert a["tokens"] == b["tokens"], "prefix cache changed outputs"
            torch.testing.assert_close(a["prompt_logits"], b["prompt_logits"], atol=1e-5,
                                       rtol=1e-5)
        assert any(r["cached_tokens"] > 0 for r in out_warm)
        assert warm.prefill_tokens_saved > 0

    def test_stored_payloads_own_their_memory(self, engine_parts):
        """A stored prefix is a clone of its n tokens, not a view of the
        max_seq buffer, and decoding never writes into it."""
        _, _, pm, pp = engine_parts["smollm-135m"]
        eng = Engine(pm, pp, EngineConfig(**self.ECFG))
        prompt = list(range(16))
        eng.generate([prompt], max_new_tokens=3)
        (entry,) = eng.prefix_cache.entries.values()
        leaf = entry.payload[0]["0"]["k"]
        assert leaf.shape[2] == 16 and leaf.untyped_storage().nbytes() == leaf.numel() * 4
        before = leaf.clone()
        eng.generate([prompt + [99, 98]], max_new_tokens=3)
        assert torch.equal(leaf, before)

    def test_launcher_runs_on_cpu(self, capsys):
        from repro_torch.launch import serve

        eng = serve.main(["--arch", "smollm-135m", "--device", "cpu", "--requests", "6",
                          "--max-new-tokens", "2"])
        assert eng.stats()["requests"] == 6
        assert "served 6 requests" in capsys.readouterr().out

    def test_launcher_runs_rwkv_on_cpu(self, capsys):
        """Its prompts end inside a block, so no state is ever stored, as in
        the reference launcher."""
        from repro_torch.launch import serve

        eng = serve.main(["--arch", "rwkv6-7b", "--device", "cpu", "--requests", "6",
                          "--max-new-tokens", "2"])
        assert eng.stats()["requests"] == 6
        assert "served 6 requests" in capsys.readouterr().out
        assert eng.prefix_cache.entries
        assert all(e.payload is None for e in eng.prefix_cache.entries.values())
