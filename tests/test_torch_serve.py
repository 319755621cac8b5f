"""tpuframe_torch.serve against tpuframe.serve.

  - the kv_cache helpers give the JAX helpers' answers;
  - for the same weights, the port's LMEngine (CPU) emits exactly the JAX
    LMEngine's greedy token streams, on full and ragged prompts;
  - the scheduler's admit / retire / EOS behaviour mirrors
    tests/test_serve.py over the same fake engine;
  - run_loadgen completes every request on the real (tiny) engine;
  - an engine asked for CUDA on a host without it raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tpuframe.models import transformer_lm as jax_lm  # noqa: E402
from tpuframe.serve import kv_cache as jax_kv  # noqa: E402
from tpuframe.serve.engine import LMEngine as JaxLMEngine  # noqa: E402
from tpuframe_torch.models.convert import params_from_jax  # noqa: E402
from tpuframe_torch.models.transformer_lm import LMConfig  # noqa: E402
from tpuframe_torch.serve import kv_cache as kv  # noqa: E402
from tpuframe_torch.serve import loadgen  # noqa: E402
from tpuframe_torch.serve.engine import (LMEngine,  # noqa: E402
                                         golden_parity_check)
from tpuframe_torch.serve.scheduler import Request, Scheduler  # noqa: E402

BUCKETS = (16, 32)
BLOCK = 16
DECODE_TOKENS = 6


# ---------------------------------------------------------------------------
# kv_cache helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [1, 15, 16, 17, 32, 33])
def test_bucket_for_agrees(length):
    def run(mod):
        try:
            return mod.bucket_for(length, BUCKETS)
        except ValueError as e:
            return str(e)
    assert run(kv) == run(jax_kv)


@pytest.mark.parametrize("ctx,block", [(1, 16), (16, 16), (17, 16),
                                       (512, 128), (516, 128)])
def test_capacity_for_agrees(ctx, block):
    assert kv.capacity_for(ctx, block) == jax_kv.capacity_for(ctx, block)


@pytest.mark.parametrize("text", ["64,128, 256", "256;64", "32"])
def test_parse_buckets_agrees(text):
    assert kv.parse_buckets(text) == jax_kv.parse_buckets(text)


@pytest.mark.parametrize("buckets,cap", [((16, 32), 32), ((32, 16), 32),
                                         ((16, 64), 32), ((12,), 40)])
def test_check_buckets_agrees(buckets, cap):
    assert kv.check_buckets(buckets, cap) == \
        jax_kv.check_buckets(buckets, cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spec_agrees(dtype):
    port = kv.spec_for_model(LMConfig(dtype=dtype), slots=4, capacity=512)
    ref = jax_kv.spec_for_model(jax_lm.LMConfig(dtype=dtype), slots=4,
                                capacity=512)
    got = (port.layer_shape(), port.bytes_per_token(), port.total_bytes())
    assert got == (ref.layer_shape(), ref.bytes_per_token(),
                   ref.total_bytes())
    if dtype == "bfloat16":   # full width: 36,864 B a token, 75.5 MB
        assert got[1:] == (36864, 75_497_472)
    with pytest.raises(ValueError, match="multiple of"):
        kv.spec_for_model(LMConfig.tiny(), slots=4, capacity=65)


def test_init_cache_and_env_resolution(monkeypatch):
    spec = kv.spec_for_model(LMConfig.tiny(), slots=2, capacity=16)
    layers, lengths = kv.init_cache(spec, "cpu")
    assert len(layers) == 2 and layers[0][0].shape == spec.layer_shape()
    assert lengths.shape == (2,) and not lengths.any()
    monkeypatch.delenv("TPUFRAME_TUNE_GEN", raising=False)
    for var in ("TPUFRAME_SERVE_BUCKETS", "TPUFRAME_DECODE_BLOCK"):
        monkeypatch.delenv(var, raising=False)
    assert kv.resolve_buckets() == jax_kv.resolve_buckets()
    assert kv.resolve_decode_block() == jax_kv.resolve_decode_block()
    monkeypatch.setenv("TPUFRAME_SERVE_BUCKETS", "32,96")
    monkeypatch.setenv("TPUFRAME_DECODE_BLOCK", "32")
    assert kv.resolve_buckets() == jax_kv.resolve_buckets() == (32, 96)
    assert kv.resolve_decode_block() == jax_kv.resolve_decode_block() == 32


# ---------------------------------------------------------------------------
# The engines: identical greedy streams for identical weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    cfg = jax_lm.LMConfig.tiny(attn_impl="pallas")
    max_context = max(BUCKETS) + DECODE_TOKENS
    jax_engine = JaxLMEngine(cfg, slots=2, prompt_buckets=BUCKETS,
                             decode_block=BLOCK, max_context=max_context,
                             seed=0, enable_persistent_cache=False)
    params = params_from_jax(jax.tree.map(np.asarray, jax_engine.params))
    port = LMEngine(LMConfig.tiny(attn_impl="pallas"), params, slots=2,
                    prompt_buckets=BUCKETS, decode_block=BLOCK,
                    max_context=max_context, device="cpu")
    return jax_engine, port


def _stream(engine, prompts):
    """Prefill each prompt into its own slot, then decode every slot."""
    engine.reset()
    streams = []
    for slot, ids in enumerate(prompts):
        first, pcache, length = engine.prefill(ids)
        engine.insert(slot, pcache, length, first)
        streams.append([first])
    for _ in range(DECODE_TOKENS):
        toks = engine.decode_step()
        for slot, s in enumerate(streams):
            s.append(int(toks[slot]))
    return streams


@pytest.mark.parametrize("bucket", BUCKETS)
def test_engine_streams_match_jax(engines, bucket):
    jax_engine, port = engines
    rng = np.random.default_rng(bucket)
    prompts = [list(rng.integers(0, 512, n)) for n in (bucket, bucket - 3)]
    assert _stream(port, prompts) == _stream(jax_engine, prompts)


def test_prefill_cache_matches_jax(engines):
    jax_engine, port = engines
    ids = list(np.random.default_rng(9).integers(0, 512, 21))
    jtok, jcache, jlen = jax_engine.prefill(ids)
    tok, cache, length = port.prefill(ids)
    assert (tok, length) == (jtok, jlen)
    for (jk, jv), (k, v) in zip(jcache, cache):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)


def test_golden_parity_every_bucket():
    cfg = LMConfig.tiny(attn_impl="pallas")
    cap = kv.capacity_for(max(BUCKETS) + 4, BLOCK)
    assert golden_parity_check(cfg, buckets=BUCKETS, capacity=cap,
                               decode_tokens=4, device="cpu") == []
    assert any("exceeds capacity" in p for p in golden_parity_check(
        cfg, buckets=(32,), capacity=32, device="cpu"))


def test_engine_without_device_raises_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        LMEngine(LMConfig.tiny())


def test_loadgen_completes_every_request():
    engine = LMEngine(LMConfig.tiny(attn_impl="pallas"), slots=2,
                      prompt_buckets=BUCKETS, decode_block=BLOCK,
                      max_context=40, device="cpu")
    reqs = loadgen.synthetic_requests(6, buckets=BUCKETS, vocab_size=512,
                                      max_new_tokens=4, seed=1)
    stats = loadgen.run_loadgen(engine, reqs)
    assert stats["requests"] == 6 and stats["unfinished"] == 0
    assert stats["total_tokens"] == 24
    assert all(len(r.tokens) == 4 and r.ttft_ms() >= 0 for r in reqs)


# ---------------------------------------------------------------------------
# Scheduler semantics over a fake engine (tests/test_serve.py:214-290)
# ---------------------------------------------------------------------------

class _FakeEngine:
    """Slot bookkeeping only: prefill echoes, decode counts up."""

    def __init__(self, slots=2, buckets=(8, 16), eos_id=None):
        self.slots = slots
        self.prompt_buckets = buckets
        self.eos_id = eos_id
        self._active = {}

    def prefill(self, prompt):
        return 100 + len(prompt), ("pcache", len(prompt)), len(prompt)

    def insert(self, slot, pcache, length, first_token):
        self._active[slot] = first_token

    def decode_step(self):
        out = np.zeros(self.slots, np.int32)
        for slot, tok in self._active.items():
            self._active[slot] = tok + 1
            out[slot] = tok + 1
        return out


def test_admission_rejects_oversized_prompt():
    sched = Scheduler(_FakeEngine(buckets=(8,)))
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        sched.submit(Request(rid=0, prompt=list(range(9))))


def test_continuous_batching_admits_and_retires():
    eng = _FakeEngine(slots=2)
    sched = Scheduler(eng)
    for rid in range(5):
        sched.submit(Request(rid=rid, prompt=[1, 2, 3], max_new_tokens=3))
    steps = 0
    while sched.has_work():
        sched.step()
        steps += 1
        assert steps < 50
    assert len(sched.completed) == 5
    assert [r.rid for r in sched.completed[:2]] == [0, 1]
    for r in sched.completed:
        assert len(r.tokens) == 3
        assert r.ttft_ms() is not None and r.ttft_ms() >= 0
        assert r.tpot_ms() is not None and r.tpot_ms() >= 0
    assert len(sched.completed) > eng.slots


def test_eos_retires_early():
    sched = Scheduler(_FakeEngine(slots=1, eos_id=104))
    sched.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=50))
    while sched.has_work():
        sched.step()
    (req,) = sched.completed
    assert req.tokens[-1] == 104 and len(req.tokens) == 2
    assert req.trace is None


def test_retire_then_admit_fills_freed_slot_same_step():
    sched = Scheduler(_FakeEngine(slots=1))
    sched.submit(Request(rid=0, prompt=[1, 2], max_new_tokens=2))
    sched.submit(Request(rid=1, prompt=[3, 4], max_new_tokens=2))
    sched.step()
    assert [r.rid for r in sched.completed] == [0]
    follower = sched.active[0]
    assert follower is not None and follower.rid == 1
    assert len(follower.tokens) == 1 and follower.first_token_t is not None
    sched.step()
    assert [r.rid for r in sched.completed] == [0, 1]
    assert all(len(r.tokens) == 2 for r in sched.completed)


def test_instant_retire_reuses_slot_within_admit_pass():
    sched = Scheduler(_FakeEngine(slots=1))
    for rid in range(3):
        sched.submit(Request(rid=rid, prompt=[rid], max_new_tokens=1))
    assert sched.step() == 3
    assert not sched.has_work()
    assert [r.rid for r in sched.completed] == [0, 1, 2]
    assert all(len(r.tokens) == 1 and r.done_t is not None
               for r in sched.completed)
