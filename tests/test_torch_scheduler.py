"""The port's continuous batcher against the JAX package's, on the reduced
llama3.2-1b, deepseek-v2-236b, zamba2-7b and xlstm-125m in f32.

Both sides start from the same weights (the port's CPU draws, bridged to
the reference bitwise) and take the same requests.  Slot recycling and
chunked prefill must be exact: the port's batcher emits the same tokens
as the reference's batcher and as the port's ``ServeEngine`` run request
by request at the batcher's ``view_len`` (the attention's reduction
width), and its counters (steps, admissions, completions, preemptions,
tokens) equal the reference's on the same trace.  The recurrent families
step one token at a time, as the reference's.  On llama3.2-1b also:
preemption on a tiny pool with exact resume, the deadline policy,
priority order, refused requests, utilisation.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.models import build_model as jbuild_model         # noqa: E402
from repro.serving import ContinuousBatcher as JBatcher      # noqa: E402
from repro.serving import Request as JRequest                # noqa: E402
from repro.serving import SLOConfig as JSLOConfig            # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.models import build_model                   # noqa: E402
from repro_torch.serving import (ContinuousBatcher, Request,  # noqa: E402
                                 ServeEngine, SLOConfig)

jax.config.update("jax_platform_name", "cpu")

FAMILIES = ("llama3.2-1b", "deepseek-v2-236b", "zamba2-7b", "xlstm-125m")
COUNTERS = ("sched/steps", "sched/admitted", "sched/completed",
            "sched/preempted", "sched/tokens", "sched/slot_steps",
            "sched/active_slot_steps")


def _build(arch):
    tmodel = build_model(get_config(arch).reduced())
    params = tmodel.init(seed=0, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(params))
    return jbuild_model(jget_config(arch).reduced()), jparams, tmodel, params


@pytest.fixture(scope="module", params=FAMILIES)
def models(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def llama():
    return _build("llama3.2-1b")


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, vocab, (int(n),)).astype(np.int32)
            for n in lens]


def _run_both(models, prompts, max_new, **kw):
    """The same requests through both batchers; returns (port batcher,
    {uid: port output}, reference batcher, {uid: reference output})."""
    jmodel, jparams, tmodel, params = models
    out = []
    for batcher, req, slo, p, m in (
            (ContinuousBatcher, Request, SLOConfig, params, tmodel),
            (JBatcher, JRequest, JSLOConfig, jparams, jmodel)):
        chunk = kw.get("prefill_chunk")
        cb = batcher(m, p, slo=slo(prefill_chunk=chunk) if chunk else None,
                     **{k: v for k, v in kw.items() if k != "prefill_chunk"})
        for i, pr in enumerate(prompts):
            cb.submit(req(uid=i, prompt=pr, max_new=max_new))
        done = cb.run()
        assert len(done) == len(prompts)
        out += [cb, {r.uid: list(r.output) for r in done}]
    return out


def _counters(cb):
    return {k: cb.metrics.counter(k).value for k in COUNTERS}


def _engine_equal(tmodel, params, cb, prompts, outputs, max_new):
    eng = ServeEngine(tmodel, params, cache_len=cb.paged.view_len)
    for uid, pr in enumerate(prompts):
        ref = eng.generate(pr[None], max_new=max_new)[0]
        got = outputs[uid][:len(ref)]
        assert got == ref[:len(got)].tolist(), uid


def test_batcher_equals_reference_and_engine(models):
    """Chunked prefill (4 tokens a step) mixed with decode on 2 slots;
    five requests, so slots are recycled."""
    jmodel, jparams, tmodel, params = models
    prompts = _prompts(tmodel.cfg.vocab, (9, 3, 12, 5, 7), seed=1)
    cb, got, jcb, want = _run_both(models, prompts, 6, n_slots=2,
                                   cache_len=32, prefill_chunk=4)
    assert got == want
    assert _counters(cb) == _counters(jcb)
    assert cb.paged.view_len == jcb.paged.view_len
    _engine_equal(tmodel, params, cb, prompts, got, 6)


def test_preemption_tiny_pool_resumes_exactly(llama):
    """A pool too small for all slots preempts; every request completes
    with the tokens of an unpreempted run, as the reference's does."""
    _, _, tmodel, params = llama
    prompts = _prompts(tmodel.cfg.vocab, (8, 8, 8, 8, 8), seed=2)
    cb, got, jcb, want = _run_both(llama, prompts, 8, n_slots=3,
                                   cache_len=32, block_size=4, n_blocks=10,
                                   prefill_chunk=4)
    assert cb.metrics.counter("sched/preempted").value > 0
    assert got == want
    assert _counters(cb) == _counters(jcb)
    assert cb.paged.n_free_blocks == cb.paged.n_blocks
    _engine_equal(tmodel, params, cb, prompts, got, 8)


def test_priority_ordering(llama):
    """With one slot, the urgent request submitted last runs first; the
    equal-priority pair then drains in FIFO order."""
    _, _, tmodel, params = llama
    prompts = _prompts(tmodel.cfg.vocab, (4, 4, 4), seed=3)
    cb = ContinuousBatcher(tmodel, params, n_slots=1, cache_len=32)
    for uid, prio in ((0, 5), (1, 5), (2, 0)):
        cb.submit(Request(uid=uid, prompt=prompts[uid], max_new=4,
                          priority=prio))
    assert cb.queue_depth == 3
    assert [r.uid for r in cb.run()] == [2, 0, 1]
    assert cb.queue_depth == 0


def test_submit_rejects_impossible_requests(llama):
    _, _, tmodel, params = llama
    cb = ContinuousBatcher(tmodel, params, n_slots=1, cache_len=16)
    with pytest.raises(ValueError, match="cache_len"):
        cb.submit(Request(uid=0, prompt=np.zeros(12, np.int32), max_new=8))
    small = ContinuousBatcher(tmodel, params, n_slots=2, cache_len=64,
                              block_size=4, n_blocks=4)
    with pytest.raises(ValueError, match="could never complete"):
        small.submit(Request(uid=1, prompt=np.zeros(12, np.int32),
                             max_new=8))
    assert small.queue_depth == 0


def test_utilisation_accounting(llama):
    _, _, tmodel, params = llama
    cb = ContinuousBatcher(tmodel, params, n_slots=4, cache_len=16)
    cb.submit(Request(uid=0, prompt=np.array([5, 6], np.int32), max_new=3))
    assert len(cb.run()) == 1
    assert abs(cb.utilisation - 0.25) < 1e-6       # one request, 4 slots
    assert cb.metrics.counter("sched/completed").value == 1
    assert cb.metrics.counter("sched/admitted").value == 1
    assert cb.metrics.histogram("serve/ttft").summary()["count"] == 1
    assert cb.metrics.gauge("sched/free_blocks").value == \
        cb.paged.n_blocks
    assert not cb.step()                           # nothing left to do


def test_deadline_preemption_matches_reference(llama):
    """A running request past its deadline (0 ms) yields its slot to a
    more urgent arrival, resumes after it and finishes with the tokens it
    would have had; both batchers take the same steps."""
    jmodel, jparams, tmodel, params = llama
    prompts = _prompts(tmodel.cfg.vocab, (6, 5), seed=5)
    runs = []
    for batcher, req, p, m in ((ContinuousBatcher, Request, params, tmodel),
                               (JBatcher, JRequest, jparams, jmodel)):
        cb = batcher(m, p, n_slots=1, cache_len=32)
        late = req(uid=0, prompt=prompts[0], max_new=6, priority=5,
                   deadline_ms=0.0)
        cb.submit(late)
        done = []
        assert cb.step(done)                       # the late one admitted
        cb.submit(req(uid=1, prompt=prompts[1], max_new=6, priority=0))
        while cb.step(done):
            pass
        assert [r.uid for r in done] == [1, 0] and late.n_preempted == 1
        runs.append((cb, {r.uid: list(r.output) for r in done}))
    (cb, got), (jcb, want) = runs
    assert got == want
    assert _counters(cb) == _counters(jcb)
    assert cb.metrics.counter("sched/preempted").value == 1
    _engine_equal(tmodel, params, cb, prompts, got, 6)
