"""The port's five examples (``examples/*_torch.py``), each run in
process through ``main(argv)`` at a small size with ``--device cpu``,
their deterministic outputs held against the reference library on the
same inputs:

  * quickstart (4 steps a run): the three strategies' accumulated and
    wire bytes (and strategy names) equal the reference's
    ``exchange_stats`` on its own gradient tree, and the two trained
    models agree within the example's 1e-4;
  * train_nmt (``--small``): finite losses, two greedy samples;
  * scaling_comparison in a world of 1: every row's plan bytes and
    collective count equal the reference's, gather and reduce train the
    same model;
  * serve_batch and continuous_serving (reduced llama3.2-1b, f32): the
    tokens, before and after the hot swap, and the batcher's counters
    equal the reference's engine and batcher started from the same
    weights (the port's CPU draws of seeds 0 and 7, bridged);
  * without ``--device`` every example asks for the card, and raises here.
"""
import importlib.util
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
import numpy as np                                            # noqa: E402

from repro.configs import get_config as jget_config            # noqa: E402
from repro.core import DistributedOptimizer as JOptimizer      # noqa: E402
from repro.core import ExchangeConfig as JExchangeConfig       # noqa: E402
from repro.data import make_pipeline as jmake_pipeline         # noqa: E402
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.optim import adamw as jadamw                        # noqa: E402
from repro.serving import ContinuousBatcher as JBatcher        # noqa: E402
from repro.serving import Request as JRequest                  # noqa: E402
from repro.serving import ServeEngine as JServeEngine          # noqa: E402
from repro.serving import SLOConfig as JSLOConfig              # noqa: E402
from repro.training.gradients import \
    abstract_grad_contributions                               # noqa: E402
from repro_torch import bridge                                 # noqa: E402
from repro_torch.configs import get_config                     # noqa: E402
from repro_torch.models import build_model                     # noqa: E402

jax.config.update("jax_platform_name", "cpu")

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
NAMES = ("quickstart", "train_nmt", "scaling_comparison", "serve_batch",
         "continuous_serving")


def example(name):
    path = os.path.join(EXAMPLES, f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_grads(batch: int, seq: int, **pipe_kw):
    """The reference's reduced transformer-big gradient tree (abstract:
    the byte accounting needs only its structure)."""
    cfg = jget_config("transformer-big").reduced()
    model = jbuild_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    b = {k: jnp.asarray(v) for k, v in
         jmake_pipeline(cfg, batch, seq, **pipe_kw).batch_at(0).items()}
    return abstract_grad_contributions(model, params, b,
                                       sparse_embedding=True)


def bridged(arch: str, seed: int):
    """The reference's model and the port's CPU draws of ``seed`` as its
    parameters."""
    model = build_model(get_config(arch).reduced())
    params = model.init(seed=seed, device="cpu")
    return (jbuild_model(jget_config(arch).reduced()),
            jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(params)))


def test_quickstart_buffers_and_models():
    got = example("quickstart").main(["--steps", "4", "--device", "cpu"])
    g = reference_grads(8, 32, task="copy")
    configs = (JExchangeConfig(), JExchangeConfig(sparse_as_dense=True),
               JExchangeConfig(sparse_as_dense=True, codec="int8"))
    assert len(got["buffers"]) == len(configs)
    for stats, cfg in zip(got["buffers"].values(), configs):
        want = JOptimizer(jadamw(3e-3), exchange=cfg).exchange_stats(
            g, n_workers=64)
        assert (stats.accumulated_bytes, stats.wire_bytes,
                stats.n_collectives, stats.strategy) == (
            want.accumulated_bytes, want.wire_bytes, want.n_collectives,
            want.strategy)
    sizes = [s.accumulated_bytes for s in got["buffers"].values()]
    assert sizes[0] > 10 * sizes[1]          # the paper's pathology
    assert got["max_param_diff"] < 1e-4


def test_train_nmt_small():
    got = example("train_nmt").main(["--small", "--steps", "2",
                                     "--device", "cpu"])
    assert [h["step"] for h in got["history"]] == [1, 2]
    assert all(math.isfinite(h["loss"]) for h in got["history"])
    assert got["generations"].shape[0] == 2
    assert 1 <= got["generations"].shape[1] <= 8


def test_scaling_comparison_plan_bytes_in_a_world_of_one():
    got = example("scaling_comparison").main(
        ["--device", "cpu", "--codec", "bf16", "--reduce-scatter"])
    assert got["n_workers"] == 1
    g = reference_grads(2, 32)
    configs = {"sparse_gather": JExchangeConfig(sparse_as_dense=False),
               "dense_reduce": JExchangeConfig(sparse_as_dense=True),
               "dense_rs_bf16": JExchangeConfig(
                   sparse_as_dense=True, reduce_scatter=True, codec="bf16")}
    assert list(got["rows"]) == list(configs)
    for name, cfg in configs.items():
        want = JOptimizer(jadamw(3e-3), exchange=cfg,
                          axis_name=("data",)).exchange_stats(g, n_workers=1)
        row = got["rows"][name]
        assert (row["accumulated_bytes"], row["wire_bytes"],
                row["n_collectives"]) == (want.accumulated_bytes,
                                          want.wire_bytes, want.n_collectives)
        assert math.isfinite(row["final_loss"])
    assert got["max_param_diff"]["sparse_gather"] < 1e-4
    assert got["max_param_diff"]["dense_rs_bf16"] < 5e-2


def test_serve_batch_tokens_equal_reference():
    got = example("serve_batch").main(["--device", "cpu", "--max-new", "6",
                                       "--hot-swap"])
    jmodel, jparams = bridged("llama3.2-1b", 0)
    eng = JServeEngine(jmodel, jparams, cache_len=12 + 6 + 1)
    np.testing.assert_array_equal(got["tokens"],
                                  eng.generate(got["prompts"], max_new=6))
    stream = eng.begin_hot_swap(bridged("llama3.2-1b", 7)[1])
    while not eng.hot_swap_step():
        pass
    assert got["swap_buckets"] == stream.n_buckets
    np.testing.assert_array_equal(got["swap_tokens"],
                                  eng.generate(got["prompts"], max_new=6))


def test_continuous_serving_tokens_and_counters_equal_reference():
    mod = example("continuous_serving")
    got = mod.main(["--device", "cpu", "--requests", "8", "--hot-swap"])
    jmodel, jparams = bridged("llama3.2-1b", 0)
    vocab = jget_config("llama3.2-1b").reduced().vocab
    rng = np.random.default_rng(0)
    cb = JBatcher(jmodel, jparams, n_slots=4, cache_len=48, n_blocks=None,
                  slo=JSLOConfig(ttft_target_ms=500.0, tpot_target_ms=100.0,
                                 prefill_chunk=4))
    for i in range(8):
        plen = int(rng.integers(3, 10))
        cb.submit(JRequest(
            uid=i, prompt=rng.integers(4, vocab, (plen,)).astype(np.int32),
            max_new=int(rng.integers(4, 12)),
            priority=int(rng.integers(0, 3))))
    stream = cb.begin_hot_swap(bridged("llama3.2-1b", 7)[1])
    done = cb.run()
    assert got["swap_buckets"] == stream.n_buckets
    assert got["params_version"] == cb.params_version == 1
    assert got["outputs"] == {r.uid: list(r.output) for r in done}
    assert got["counters"] == {k: cb.metrics.counter(k).value
                               for k in mod.COUNTERS}


@pytest.mark.parametrize("name", NAMES)
def test_examples_default_to_the_card(name):
    """Without ``--device`` an example asks for CUDA; with no card that
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        example(name).main([])
