"""The port's dynamic loss scaling and loss-scaled step against the JAX
package's.

On the reduced transformer-big (f32), parameters bridged from the
reference's ``init``, one seed-made batch of 4 x 8 tokens:

  * ``accumulate_partial_microbatches`` at M = 4, dense and sparse
    embedding: structure exact, gradients within rtol 5e-5, atol 5e-6,
    the loss sum within rtol 1e-5 (``tests/test_microbatch.py``'s);
  * ``LossScaler`` growth and backoff: the exact case of
    ``tests/test_microbatch.py::test_loss_scaler_growth_and_backoff``;
  * one ``make_scaled_train_step`` step at M = 4 against the reference
    at ``tests/test_torch_train.py``'s tolerances (loss rtol 1e-5, Adam
    moments atol 1e-5 rtol 1e-4, parameters atol 1e-5 on all but 0.1% of
    a leaf, 2 lr elsewhere);
  * the port's overflow skip (parameters and optimizer state bitwise as
    they were, the scale halved, the int8+ef residuals rolled back to
    their values before the step and, as the reference's, multiplied by
    new / old scale = 0.5: bitwise half of them) and the residuals'
    rescale when the scale grows (bitwise twice the residual a step
    without growth leaves).
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.core import (DistributedOptimizer as JDistOpt,    # noqa: E402
                        ExchangeConfig as JExchangeConfig)
from repro.data import make_pipeline as jmake_pipeline         # noqa: E402
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.optim import adamw as jadamw                        # noqa: E402
from repro.training import microbatch as jmb                   # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.core import DistributedOptimizer, ExchangeConfig  # noqa
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.optim import adamw                             # noqa: E402
from repro_torch.training import microbatch as mb               # noqa: E402
from repro_torch.tree import tree_flatten                       # noqa: E402

from test_torch_microbatch import assert_contribs_close, jit_fast  # noqa

jax.config.update("jax_platform_name", "cpu")

LR = 1e-3


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("transformer-big").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_batch = jmake_pipeline(jcfg, 4, 8, seed=0).batch_at(0)
    model = build_model(get_config("transformer-big").reduced())
    params = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in np_batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    return jmodel, jparams, jbatch, model, params, batch


@pytest.mark.parametrize("sparse", [False, True])
def test_accumulate_partial_microbatches_matches_reference(setup, sparse):
    jmodel, jparams, jbatch, model, params, batch = setup
    jpart, jlast, jloss, jn = jit_fast(
        lambda p, b: jmb.accumulate_partial_microbatches(
            jmodel, p, jmb.split_microbatches(b, 4),
            sparse_embedding=sparse), jparams, jbatch)
    part, last, loss, n = mb.accumulate_partial_microbatches(
        model, params, mb.split_microbatches(batch, 4),
        sparse_embedding=sparse)
    assert n == int(jn) == 4
    assert_contribs_close(part, jpart)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in batch:
        np.testing.assert_array_equal(last[k].numpy(), np.asarray(jlast[k]))
    one = mb.accumulate_partial_microbatches(
        model, params, mb.split_microbatches(batch, 1))
    assert one[0] is None and one[3] == 1 and float(one[2]) == 0.0


def test_loss_scaler_growth_and_backoff():
    """tests/test_microbatch.py::test_loss_scaler_growth_and_backoff,
    on the port, with the reference's states beside it."""
    kw = dict(init_scale=8.0, growth_factor=2.0, backoff_factor=0.5,
              growth_interval=2)
    s, js = mb.LossScaler(**kw), jmb.LossScaler(**kw)
    state, jstate = s.init(device="cpu"), js.init()
    good = {"g": torch.ones(3)}
    bad = {"g": torch.tensor([1.0, float("inf"), 0.0])}
    jgood = {"g": jnp.ones((3,))}
    jbad = {"g": jnp.array([1.0, jnp.inf, 0.0])}
    flags = []
    for g, jg in ((good, jgood), (good, jgood), (bad, jbad)):
        out, f, state = s.unscale_and_check(g, state)
        jout, jf, jstate = js.unscale_and_check(jg, jstate)
        np.testing.assert_array_equal(out["g"].numpy(),
                                      np.asarray(jout["g"]))
        assert bool(f) == bool(jf)
        assert float(state.scale) == float(jstate.scale)
        assert int(state.good_steps) == int(jstate.good_steps)
        assert state.scale.dtype == torch.float32
        assert state.good_steps.dtype == torch.int32
        flags.append((bool(f), float(state.scale)))
    assert flags == [(True, 8.0), (True, 16.0), (False, 8.0)]
    assert int(state.good_steps) == 0
    assert float(s.scale_loss(torch.tensor(3.0), state)) == 24.0


def test_scaler_state_stays_on_the_device_given():
    state = mb.LossScaler().init(device="meta")
    assert state.scale.device.type == "meta"
    assert state.good_steps.device.type == "meta"


def test_scaled_step_matches_reference(setup):
    jmodel, jparams, jbatch, model, params, batch = setup
    jopt = JDistOpt(jadamw(LR), exchange=JExchangeConfig(
        sparse_as_dense=True, use_kernel=True))
    jstep = jmb.make_scaled_train_step(jmodel, jopt, jmb.LossScaler(),
                                       n_microbatches=4,
                                       sparse_embedding=True)
    jp, jst, jss, jm = jit_fast(jstep, jparams, jopt.init(jparams),
                                jmb.LossScaler().init(), jbatch)
    opt = DistributedOptimizer(adamw(LR), exchange=ExchangeConfig(
        sparse_as_dense=True, use_kernel=True))
    step = mb.make_scaled_train_step(model, opt, mb.LossScaler(),
                                     n_microbatches=4,
                                     sparse_embedding=True)
    assert step.stateful_exchange is False
    p, st, ss, ex, m = step(params, opt.init(params),
                            mb.LossScaler().init(device="cpu"), None, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert not bool(m["overflow"]) and not bool(jm["overflow"])
    assert float(m["loss_scale"]) == float(jm["loss_scale"]) == 2.0 ** 15
    assert int(st.step) == int(jst.step) == 1
    for t, j in zip(tree_flatten(st.mu)[0],
                    jax.tree_util.tree_leaves(jst.mu)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-4)
    moved = 0.0
    for t, j, p0 in zip(tree_flatten(p)[0], jax.tree_util.tree_leaves(jp),
                        tree_flatten(params)[0]):
        diff = np.abs(t.numpy() - np.asarray(j))
        assert (diff > 1e-5).mean() <= 1e-3
        assert diff.max() <= 2 * LR
        moved = max(moved, float((t - p0).abs().max()))
    assert moved > 1e-4


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8) if t.dim() else \
        t.reshape(1).view(torch.uint8)


def _all_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _all_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _all_leaves(v)]
    return [tree]


def trees_bitwise(a, b) -> bool:
    la, lb = _all_leaves(a), _all_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(la, lb))


def _int8_ef_step(model, scaler, n=4):
    opt = DistributedOptimizer(adamw(LR), exchange=ExchangeConfig(
        sparse_as_dense=True, codec="int8", error_feedback=True,
        use_kernel=True))
    step = mb.make_scaled_train_step(model, opt, scaler, n_microbatches=n,
                                     sparse_embedding=True)
    assert step.stateful_exchange is True
    return opt, step


def _residuals(ex):
    return [s for s in ex.bucket_states if isinstance(s, torch.Tensor)]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_clone(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return tree.clone()


def test_overflow_skips_and_rolls_back_residuals(setup):
    _, _, _, model, params, batch = setup
    scaler = mb.LossScaler()
    opt, step = _int8_ef_step(model, scaler)
    p, st, ss, ex, m = step(params, opt.init(params),
                            scaler.init(device="cpu"),
                            opt.init_exchange_state(
                                mb._scale_grad_tree(
                                    mb.accumulate_microbatches(
                                        model, params,
                                        mb.split_microbatches(batch, 4),
                                        sparse_embedding=True)[0],
                                    torch.tensor(1.0)), device="cpu"),
                            batch)
    assert not bool(m["overflow"])
    res = _residuals(ex)
    assert len(res) == 16 and all(float(r.abs().max()) > 0 for r in res)
    bad = dict(p)
    bad["embedding"] = p["embedding"].clone()
    bad["embedding"][0, 0] = float("nan")
    before = (_clone(bad), _clone(st), [r.clone() for r in res])
    p2, st2, ss2, ex2, m2 = step(bad, st, ss, ex, batch)
    assert bool(m2["overflow"])
    assert trees_bitwise(p2, before[0])
    assert trees_bitwise(st2, before[1])
    # rolled back to the residuals before the step, then moved to the
    # backed-off scale's units as the reference does (new / old = 0.5)
    res2 = _residuals(ex2)
    assert all(torch.equal(_bits(a), _bits(b * 0.5))
               for a, b in zip(res2, before[2]))
    assert all(bool(torch.isfinite(a).all()) for a in res2)
    assert float(ss2.scale) == float(ss.scale) * 0.5
    assert int(ss2.good_steps) == 0


def test_growth_rescales_residuals_exactly(setup):
    _, _, _, model, params, batch = setup
    grow = mb.LossScaler(growth_interval=2)
    hold = mb.LossScaler(growth_interval=1000)
    opt, step_grow = _int8_ef_step(model, grow)
    _, step_hold = _int8_ef_step(model, hold)
    meta = mb._scale_grad_tree(mb.accumulate_microbatches(
        model, params, mb.split_microbatches(batch, 4),
        sparse_embedding=True)[0], torch.tensor(1.0))
    p, st, ss, ex, m = step_grow(params, opt.init(params),
                                 grow.init(device="cpu"),
                                 opt.init_exchange_state(meta,
                                                         device="cpu"),
                                 batch)
    assert float(ss.scale) == 2.0 ** 15 and int(ss.good_steps) == 1
    snap = (_clone(p), _clone(st), _clone(ss),
            [r.clone() for r in _residuals(ex)])
    ph, sth, ssh, exh, _ = step_hold(snap[0], snap[1], snap[2],
                                     type(ex)([r.clone() if isinstance(
                                         r, torch.Tensor) else r
                                         for r in ex.bucket_states]),
                                     batch)
    pg, stg, ssg, exg, mg = step_grow(p, st, ss, ex, batch)
    assert not bool(mg["overflow"])
    assert float(ssh.scale) == 2.0 ** 15
    assert float(ssg.scale) == 2.0 ** 16 and int(ssg.good_steps) == 0
    assert trees_bitwise(pg, ph) and trees_bitwise(stg, sth)
    for g, h in zip(_residuals(exg), _residuals(exh)):
        assert torch.equal(_bits(g), _bits(h * 2))
        assert float(h.abs().max()) > 0
