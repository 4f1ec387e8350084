"""The loss-scaled step's exchange plan in bf16, port against reference.

The reference multiplies the gradients by a strongly typed f32 loss
scale, so JAX promotes bf16 contributions to f32 and the fused and
staged paths exchange f32 buckets; on the wait-free path only the
deferred microbatches' ``partial`` is scaled after the fact, so it
exchanges f32 at M > 1 and bf16 (the final microbatch's own cotangents)
at M = 1.  A bf16 PyTorch tensor times a 0-dim f32 tensor stays bf16, so
the port must promote on purpose to move the same bytes.

The reduced transformer-big cast to bf16 takes one
``make_scaled_train_step`` step on the port (CPU) for fused, staged and
backward overlap at M = 1 and 4, with every plan it compiles recorded;
the reference's step is traced with ``jax.eval_shape`` with the same
recording.  The plans must be equal exactly: leaf specs (wire dtypes),
bucket layout, schedule, ``wire_bytes`` and ``n_collectives``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

import repro.core.exchange as jexchange                         # noqa: E402
import repro_torch.core.exchange as exchange                    # noqa: E402
from repro.configs import get_config as jget_config            # noqa: E402
from repro.core import (DistributedOptimizer as JDistOpt,      # noqa: E402
                        ExchangeConfig as JExchangeConfig)
from repro.data import make_pipeline as jmake_pipeline           # noqa: E402
from repro.models import build_model as jbuild_model             # noqa: E402
from repro.optim import adamw as jadamw                          # noqa: E402
from repro.training import microbatch as jmb                     # noqa: E402
from repro_torch import bridge                                    # noqa: E402
from repro_torch.configs import get_config                        # noqa: E402
from repro_torch.core import DistributedOptimizer, ExchangeConfig  # noqa
from repro_torch.models import build_model                        # noqa: E402
from repro_torch.optim import adamw                               # noqa: E402
from repro_torch.training import microbatch as mb                 # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("transformer-big").reduced().with_(dtype="bfloat16")
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_batch = jmake_pipeline(jcfg, 4, 8, seed=0).batch_at(0)
    model = build_model(get_config("transformer-big").reduced().with_(
        dtype="bfloat16"))
    params = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    assert params["embedding"].dtype == torch.bfloat16
    batch = {k: torch.from_numpy(np.array(v)) for k, v in np_batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    return jmodel, jparams, jbatch, model, params, batch


def _recorder(monkeypatch, module):
    plans = []
    real = module.compile_plan

    def record(grads, config):
        plan = real(grads, config)
        plans.append(plan)
        return plan
    monkeypatch.setattr(module, "compile_plan", record)
    return plans


def _spec(s):
    d = dataclasses.asdict(s)
    d["dtype"] = str(d["dtype"])
    return tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                        for k, v in d.items()))


def describe(plan):
    """Everything of a plan the two packages must agree on."""
    return {
        "leaf_specs": tuple(_spec(s) for s in plan.leaf_specs),
        "buckets": tuple((b.wire_dtype, b.n_elems,
                          tuple((s.leaf_idx, s.offset, s.size)
                                for s in b.slots))
                         for b in plan.dense_buckets),
        "dense_leaf_ids": tuple(plan.dense_leaf_ids),
        "gather_leaf_ids": tuple(plan.gather_leaf_ids),
        "stages": tuple((s.kind, s.bucket_id, tuple(s.leaf_ids), s.trigger)
                        for s in plan.schedule.stages),
        "wire_bytes": tuple(plan.wire_bytes(p) for p in (2, 8)),
        "n_collectives": plan.n_collectives,
    }


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("overlap", [False, "staged", "backward"])
def test_scaled_step_exchanges_the_reference_wire(setup, monkeypatch,
                                                  overlap, n):
    jmodel, jparams, jbatch, model, params, batch = setup
    jplans = _recorder(monkeypatch, jexchange)
    jopt = JDistOpt(jadamw(1e-3), exchange=JExchangeConfig(
        sparse_as_dense=True, overlap=overlap))
    jstep = jmb.make_scaled_train_step(jmodel, jopt, jmb.LossScaler(),
                                       n_microbatches=n,
                                       sparse_embedding=True)
    jax.eval_shape(jstep, jparams, jopt.init(jparams),
                   jmb.LossScaler().init(), jbatch)

    plans = _recorder(monkeypatch, exchange)
    opt = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
        sparse_as_dense=True, overlap=overlap))
    step = mb.make_scaled_train_step(model, opt, mb.LossScaler(),
                                     n_microbatches=n,
                                     sparse_embedding=True)
    _, _, _, _, m = step(params, opt.init(params),
                         mb.LossScaler().init(device="cpu"), None, batch)
    assert not bool(m["overflow"])

    want = {repr(describe(p)): describe(p) for p in jplans}
    got = {repr(describe(p)): describe(p) for p in plans}
    assert len(want) == 1 and got == want
    (d,) = got.values()
    wire = {b[0] for b in d["buckets"]}
    assert wire == ({"bfloat16"} if overlap == "backward" and n == 1
                    else {"float32"})
