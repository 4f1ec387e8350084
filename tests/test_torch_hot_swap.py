"""The port's weight hot swap against the JAX package's: the exchange
plan's ``broadcast`` and ``broadcast_bucket``, ``HotSwapStream``, the
engine's and the batcher's swap, ``DistributedOptimizer.broadcast``, and a
broadcast across a gloo world of 2; with the host-side metrics and the
toy tokenizer the serving examples use.

Both sides broadcast the same numpy trees (the reduced llama3.2-1b's
parameters, in f32 and cast to bf16).  The identity wire is bitwise the
reference's.  The int8 wire is bitwise the reference's plan compiled with
``use_kernel=True`` (the Pallas kernel in interpret mode, which multiplies
by ``1 / scale`` as the port does), and within one quantum a leaf of the
reference's default plan (``use_kernel=False``), whose encode divides by
the scale.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

import _torch_dist_worker                     # noqa: E402
from _torch_world import spawn_world           # noqa: E402
from repro.core import (DistributedOptimizer as JDistOpt,    # noqa: E402
                        ExchangeConfig as JExchangeConfig,
                        compile_plan as jcompile_plan)
from repro.data import ToyTokenizer as JToyTokenizer         # noqa: E402
from repro.optim import adamw as jadamw                      # noqa: E402
from repro.serving import HotSwapStream as JHotSwapStream    # noqa: E402
from repro.serving import broadcast_plan as jbroadcast_plan  # noqa: E402
from repro.telemetry.metrics import (                        # noqa: E402
    LatencyHistogram as JLatencyHistogram)
from repro_torch import bridge                               # noqa: E402
from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.core import (DistributedOptimizer,          # noqa: E402
                              ExchangeConfig, IndexedSlices, compile_plan)
from repro_torch.data import ToyTokenizer                    # noqa: E402
from repro_torch.models import build_model                   # noqa: E402
from repro_torch.optim import adamw                          # noqa: E402
from repro_torch.serving import (ContinuousBatcher,          # noqa: E402
                                 HotSwapStream, Request, ServeEngine,
                                 broadcast_params, broadcast_plan)
from repro_torch.telemetry import LatencyHistogram, MetricsLogger  # noqa: E402
from repro_torch.tree import tree_flatten                    # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "llama3.2-1b"
#: a fusion threshold that packs several leaves into one f32 bucket
FUSED = 1 << 16


@pytest.fixture(scope="module")
def trees():
    """The reduced model and two numpy parameter trees (the live weights
    and the refreshed ones)."""
    model = build_model(get_config(ARCH).reduced())
    old = bridge.to_numpy(model.init(seed=0, device="cpu"))
    new = bridge.to_numpy(model.init(seed=7, device="cpu"))
    return model, old, new


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return bridge.to_torch(tree, "cpu")


def _leaves_np(tree):
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return [bridge.tensor_to_array(t) for t in tree_flatten(tree)[0]]
    return [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(tree)]


def _bitwise(a, b):
    la, lb = _leaves_np(a), _leaves_np(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("codec", ["identity", "bf16"])
def test_linear_broadcast_is_bitwise_the_reference(trees, codec, dtype):
    _, _, new = trees
    new = _cast(new, jnp.dtype(dtype))
    got = broadcast_plan(_torch(new), codec=codec).broadcast(_torch(new),
                                                             None)
    want = jbroadcast_plan(_jax(new), codec=codec).broadcast(_jax(new), None)
    _bitwise(got, want)
    if codec == "identity":
        _bitwise(got, new)


@pytest.mark.parametrize("fusion", [None, FUSED])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_broadcast_is_bitwise_the_reference_kernel_path(trees, dtype,
                                                             fusion):
    """Single-slot buckets encode the leaf as it is (bf16 included),
    fused ones the f32 pack: both bitwise the reference's Pallas path."""
    _, _, new = trees
    new = _cast(new, jnp.dtype(dtype))
    plan = broadcast_plan(_torch(new), codec="int8", fusion_threshold=fusion)
    got = plan.broadcast(_torch(new), None)
    jplan = jcompile_plan(_jax(new), JExchangeConfig(
        sparse_as_dense=True, codec="int8", use_kernel=True,
        fusion_threshold=fusion))
    assert len(plan.dense_buckets) == len(jplan.dense_buckets)
    if fusion is None:
        assert len(plan.dense_buckets) == len(tree_flatten(new)[0])
    else:
        assert len(plan.dense_buckets) < len(tree_flatten(new)[0])
    _bitwise(got, jplan.broadcast(_jax(new), None))


def test_int8_broadcast_within_a_quantum_of_the_default_plan(trees):
    """The reference's ``broadcast_plan`` (``use_kernel=False``) divides
    by the scale; the port multiplies by its reciprocal.  Every leaf
    agrees within one quantum (its scale), and nearly every element
    exactly."""
    _, _, new = trees
    got = _leaves_np(broadcast_plan(_torch(new), codec="int8").broadcast(
        _torch(new), None))
    want = _leaves_np(jbroadcast_plan(_jax(new), codec="int8").broadcast(
        _jax(new), None))
    n = differ = 0
    for g, w, x in zip(got, want, _leaves_np(new)):
        # one step of q (the leaf's f32 scale), and the rounding of the
        # two decoded products, at most an ulp of absmax each
        absmax = np.float32(max(np.abs(x).max(), 1e-30))
        quantum = absmax * np.float32(1 / 127)
        assert np.abs(g - w).max() <= quantum + 2 * np.spacing(absmax)
        n += g.size
        differ += int((g != w).sum())
    assert differ <= n // 1000


def test_hot_swap_stream_equals_one_shot_and_reference(trees):
    _, old, new = trees
    for codec in ("identity", "int8"):
        plan = broadcast_plan(_torch(new), codec=codec)
        stream = HotSwapStream(plan, _torch(old), _torch(new), version=1)
        jstream = JHotSwapStream(
            jcompile_plan(_jax(new), JExchangeConfig(
                sparse_as_dense=True, codec=codec, use_kernel=True)),
            _jax(old), _jax(new), version=1)
        assert stream.n_buckets == jstream.n_buckets == len(
            plan.dense_buckets)
        with pytest.raises(ValueError, match="incomplete"):
            stream.result()
        steps = 0
        while not stream.step():
            jstream.step()
            steps += 1
        jstream.step()
        assert steps + 1 == stream.n_buckets == stream.buckets_done
        got = stream.result()
        _bitwise(got, plan.broadcast(_torch(new), None))
        _bitwise(got, jstream.result())


def test_stream_stages_without_touching_the_live_params(trees):
    """Until the last bucket lands, the live leaves are the old ones, and
    no tensor of the live tree is written."""
    _, old, new = trees
    live = _torch(old)
    before = [t.clone() for t in tree_flatten(live)[0]]
    stream = HotSwapStream(broadcast_plan(_torch(new)), live, _torch(new),
                           version=3)
    stream.step()
    stream.step()
    for t, b in zip(tree_flatten(live)[0], before):
        assert torch.equal(t, b)
    with pytest.raises(ValueError, match="tree changed"):
        HotSwapStream(stream.plan, live, {"embedding": live["embedding"]},
                      version=4)


def test_broadcast_params_checks_the_plan(trees):
    _, _, new = trees
    t = _torch(new)
    plan = broadcast_plan(t, codec="int8")
    _bitwise(broadcast_params(t, plan=plan), plan.broadcast(t, None))
    _bitwise(broadcast_params(t, codec="int8"), plan.broadcast(t, None))
    with pytest.raises(ValueError, match="codec"):
        broadcast_params(t, plan=plan, codec="identity")
    with pytest.raises(ValueError, match="backend"):
        broadcast_params(t, plan=plan, backend="ringsim")
    g = {"e": IndexedSlices(torch.tensor([0, 2]), torch.ones(2, 3), (4, 3))}
    with pytest.raises(ValueError, match="all-dense"):
        compile_plan(g, ExchangeConfig(codec="int8")).broadcast(g, None)


def test_engine_swap_flips_once_and_refuses_a_second(trees):
    model, old, new = trees
    metrics = MetricsLogger()
    eng = ServeEngine(model, _torch(old), cache_len=16, metrics=metrics)
    stream = eng.begin_hot_swap(_torch(new), codec="int8")
    with pytest.raises(ValueError, match="in flight"):
        eng.begin_hot_swap(_torch(old))
    assert eng.swap_in_flight
    steps = 1
    while not eng.hot_swap_step():
        assert eng.params_version == 0
        steps += 1
    assert steps == stream.n_buckets
    assert eng.params_version == 1 and not eng.swap_in_flight
    assert eng.hot_swap_step()                 # nothing left in flight
    _bitwise(eng.params, stream.plan.broadcast(_torch(new), None))
    eng.hot_swap(_torch(old))
    assert eng.params_version == 2
    _bitwise(eng.params, _torch(old))
    assert metrics.counter("serve/hot_swaps").value == 2
    assert metrics.gauge("serve/params_version").value == 2


def test_swap_under_load(trees):
    """No request drops during a swap; the flip is atomic and lands within
    n_buckets + 2 steps; the version gauge moves once; the live params
    are then the new ones."""
    model, old, new = trees
    cb = ContinuousBatcher(model, _torch(old), n_slots=2, cache_len=32)
    rng = np.random.default_rng(4)
    for i in range(4):
        cb.submit(Request(uid=i, prompt=rng.integers(
            4, model.cfg.vocab, (6,)).astype(np.int32), max_new=8))
    stream = cb.begin_hot_swap(_torch(new))
    with pytest.raises(ValueError, match="in flight"):
        cb.begin_hot_swap(_torch(new))
    done, steps = [], 0
    while cb.step(done):
        steps += 1
        assert cb.params_version in (0, 1)
        if cb.params_version == 1 and not cb.swap_in_flight:
            break
    assert cb.params_version == 1
    assert steps <= stream.n_buckets + 2
    rest = cb.run()
    assert len(done) + len(rest) == 4
    _bitwise(cb.params, _torch(new))
    assert cb.metrics.counter("serve/hot_swaps").value == 1
    assert cb.metrics.gauge("serve/params_version").value == 1


def test_latency_summary_and_generate_metrics(trees):
    model, old, _ = trees
    assert ServeEngine(model, _torch(old), cache_len=16).latency_summary() \
        == {}
    eng = ServeEngine(model, _torch(old), cache_len=16,
                      metrics=MetricsLogger())
    prompts = np.random.default_rng(5).integers(
        4, model.cfg.vocab, (2, 4)).astype(np.int32)
    out = eng.generate(prompts, max_new=3)
    summary = eng.latency_summary()
    assert set(summary) == {"serve/prefill", "serve/ttft",
                            "serve/decode_token"}
    assert summary["serve/prefill"]["count"] == 1
    assert summary["serve/ttft"]["count"] == 1
    # a decode step follows every emitted column but a last one that
    # finished every row
    finished = bool((out == eng.eos_id).any(axis=1).all())
    assert summary["serve/decode_token"]["count"] == out.shape[1] - finished
    assert eng.metrics.counter("serve/requests").value == 2
    assert eng.metrics.counter("serve/tokens").value == 2 * out.shape[1]
    for s in summary.values():
        assert s["p99_ms"] >= s["p50_ms"] > 0.0


@pytest.mark.parametrize("codec", ["identity", "int8"])
def test_distributed_optimizer_broadcast(trees, codec):
    """The local path (no group) is the plan's broadcast under the
    optimizer's own exchange config, as the reference's with no axis."""
    _, _, new = trees
    t = _torch(new)
    cfg = dict(sparse_as_dense=True, codec=codec)
    opt = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
        use_kernel=True, **cfg))
    jopt = JDistOpt(jadamw(1e-3), exchange=JExchangeConfig(
        use_kernel=True, **cfg))
    got = opt.broadcast(t)
    _bitwise(got, opt.plan(t).broadcast(t, None))
    _bitwise(got, jopt.broadcast(_jax(new)))


def test_gloo_world_of_two_lands_rank0_params_on_rank1(tmp_path, trees):
    """Each rank holds its own weights (seed = rank); after the broadcast
    from rank 0 both hold rank 0's, through the plan (identity: bitwise
    rank 0's; int8: bitwise rank 0's local round trip), through a
    ``HotSwapStream`` and through ``DistributedOptimizer.broadcast``."""
    model, old, _ = trees
    spawn_world(_torch_dist_worker.run_broadcast, 2, tmp_path, timeout=240)
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    t0 = _torch(old)                         # rank 0's weights (seed 0)
    for codec in _torch_dist_worker.BROADCAST_CODECS:
        want = tree_flatten(broadcast_plan(t0, codec=codec).broadcast(
            t0, None))[0]
        if codec == "identity":
            want = tree_flatten(t0)[0]
        for r in range(2):
            for how in ("plan", "stream", "optimizer"):
                got = res[r][f"{codec}/{how}"]
                assert len(got) == len(want)
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (codec, how, r)


def test_latency_histogram_summary_matches_reference():
    rng = np.random.default_rng(0)
    samples = rng.exponential(0.01, 1000).tolist()
    ours, ref = LatencyHistogram("x", max_samples=256), \
        JLatencyHistogram("x", max_samples=256)
    for s in samples:
        ours.observe(s)
        ref.observe(s)
    assert ours.summary() == ref.summary()
    assert ours.samples == ref.samples
    assert LatencyHistogram("e").summary() == JLatencyHistogram(
        "e").summary()


def test_toy_tokenizer_matches_reference():
    for vocab in (512, 33708):
        ours, ref = ToyTokenizer(vocab), JToyTokenizer(vocab)
        for text, n in (("hello, world", 32), ("ünïcode ✓ text", 8),
                        ("", 4)):
            np.testing.assert_array_equal(ours.encode(text, n),
                                          ref.encode(text, n))
            ids = ref.encode(text, n)
            assert ours.decode(ids) == ref.decode(ids)
