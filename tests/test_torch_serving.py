"""The port's serving runtime (``serving/gpu.py``: processor-sharing lanes
and the priority guardrail; ``serving/remote.py``: the token bucket and
the remote service's retry path; ``serving/engine.ExactCache``) against
the JAX package's: analogues of tests/test_serving.py's 10 tests.

These modules are the reference's numpy code carried over, so each case
runs on both packages' objects and every completion time, counter and
cost is held equal, with no tolerance. The reference's property test
(``hypothesis``, absent here, so it skips) becomes fixed, seeded job
lists.
"""
import numpy as np
import pytest

from repro.serving.engine import ExactCache as RefExactCache
from repro.serving.gpu import GPU as RefGPU
from repro.serving.gpu import GPUConfig as RefGPUConfig
from repro.serving.gpu import PSLane as RefPSLane
from repro.serving.remote import RemoteDataService as RefRemote
from repro.serving.remote import TokenBucket as RefTokenBucket
from repro_torch.serving.engine import ExactCache
from repro_torch.serving.gpu import GPU, GPUConfig, PSLane
from repro_torch.serving.remote import RemoteDataService, TokenBucket


def _lanes(**kw):
    return PSLane(**kw), RefPSLane(**kw)


def test_pslane_single_job_rate():
    for lane in _lanes(capacity=1000.0, v1=100.0, slots=8):
        done = []
        lane.submit(0.0, 200.0, lambda now: done.append(now))
        t = lane.next_completion()
        assert abs(t - 2.0) < 1e-9      # 200 tokens at v1 = 100 tok/s
        for j in lane.complete_due(t):
            j.callback(t)
        assert done == [2.0]


def test_pslane_processor_sharing():
    times = []
    for lane in _lanes(capacity=100.0, v1=100.0, slots=8):
        lane.submit(0.0, 100.0, lambda now: None)
        lane.submit(0.0, 100.0, lambda now: None)
        times.append(lane.next_completion())
    assert abs(times[0] - 2.0) < 1e-9 and times[0] == times[1]


@pytest.mark.parametrize("seed", range(4))
def test_pslane_work_conservation(seed):
    """Total tokens processed equals total tokens submitted, and every
    completion instant is the reference's."""
    rng = np.random.default_rng(seed)
    jobs = [(float(rng.uniform(0.0, 5.0)), float(rng.uniform(10.0, 200.0)))
            for _ in range(int(rng.integers(1, 21)))]
    runs = []
    for lane in _lanes(capacity=123.0, v1=77.0, slots=4):
        t, total, done = 0.0, 0.0, []
        for dt, tok in jobs:
            t += dt
            lane.advance(t)
            lane.submit(t, tok, lambda now: None)
            total += tok
        guard = 0
        while lane.active or lane.queue:
            nxt = lane.next_completion()
            done.append((nxt, len(lane.complete_due(nxt))))
            guard += 1
            assert guard < 1000
        assert lane.busy_tokens == pytest.approx(total, rel=1e-6)
        runs.append((done, lane.busy_tokens))
    assert runs[0] == runs[1]


def test_token_bucket_rate():
    for tb in (TokenBucket(qpm=60.0, burst=1.0),
               RefTokenBucket(qpm=60.0, burst=1.0)):
        assert tb.try_acquire(0.0)
        assert not tb.try_acquire(0.01)
        assert tb.try_acquire(1.05)


def test_token_bucket_out_of_order_acquires_monotonic():
    times = [5.0, 2.0, 8.0, 1.0, 0.5, 8.0, 3.0, 20.0, 4.0]
    port, ref = TokenBucket(qpm=600.0, burst=10.0), \
        RefTokenBucket(qpm=600.0, burst=10.0)
    prev = port.tokens
    for t in times:
        ok = port.try_acquire(t)
        assert ok == ref.try_acquire(t)
        assert port.tokens >= prev - (1.0 if ok else 0.0) - 1e-12
        assert port.tokens >= 0.0
        assert (port.tokens, port.t_last) == (ref.tokens, ref.t_last)
        prev = port.tokens
    assert port.t_last == 20.0


def test_token_bucket_backdated_refill_no_double_credit():
    for tb in (TokenBucket(qpm=60.0, burst=2.0),
               RefTokenBucket(qpm=60.0, burst=2.0)):
        assert tb.try_acquire(0.0) and tb.try_acquire(0.0)
        assert not tb.try_acquire(0.0)
        assert tb.try_acquire(1.5)
        assert not tb.try_acquire(0.2)
        assert tb.tokens == pytest.approx(0.5)


def test_exact_cache_expired_lookup_reclaims_usage():
    states = []
    for cls in (ExactCache, RefExactCache):
        c = cls(capacity_bytes=1000, max_ttl=10.0)
        c.insert("a", "va", 300, now=0.0)
        c.insert("b", "vb", 400, now=0.0)
        assert c.usage == 700
        assert c.lookup("a", now=5.0) == "va"
        assert c.lookup("a", now=15.0) is None
        assert c.usage == 400 and "a" not in c.d and "a" not in c.order
        assert c.lookup("b", now=15.0) is None
        assert c.usage == 0 and list(c.order) == []
        c.insert("c", "vc", 900, now=16.0)
        assert c.usage == 900
        states.append((dict(c.d), list(c.order), c.usage))
    assert states[0] == states[1]


def test_remote_retry_counts():
    outs = []
    for cls in (RemoteDataService, RefRemote):
        svc = cls(qpm=60.0, seed=0)
        t, fetched = 0.0, []
        for _ in range(20):
            out = svc.fetch(t)
            fetched.append((out.finish, out.retries))
            t += 0.05                 # offered load 20/s against 1/s
        assert svc.retry_ratio > 0.3 and svc.calls == 20
        assert svc.total_cost == pytest.approx(20 * svc.cost_per_call)
        outs.append((fetched, svc.retry_ratio, svc.calls, svc.total_cost))
    assert outs[0] == outs[1]


def test_priority_guardrail():
    for gpu_cls, cfg_cls in ((GPU, GPUConfig), (RefGPU, RefGPUConfig)):
        gpu = gpu_cls(cfg_cls(agent_slots=2, colocated=True))
        for _ in range(3):
            gpu.agent.submit(0.0, 100.0, lambda now: None)
        assert gpu.agent.n_waiting == 1
        assert not gpu.judge_admission_ok()
        gpu2 = gpu_cls(cfg_cls(agent_slots=2, colocated=False))
        for _ in range(3):
            gpu2.agent.submit(0.0, 100.0, lambda now: None)
        assert gpu2.judge_admission_ok()


def test_no_rate_limit_service():
    outs = []
    for cls in (RemoteDataService, RefRemote):
        out = cls(qpm=None, seed=0).fetch(0.0)
        assert out.retries == 0 and 0.3 <= out.finish <= 0.5
        outs.append((out.finish, out.retries))
    assert outs[0] == outs[1]
