"""The partitioned train step on real CPU tensors: a gloo world of 4 as a
(2, 2) ("data", "model") mesh (``tests/_torch_dist_worker.py::
run_partitioned``, spawned once), FSDP layouts and remat, for the
reduced llama3.2-1b and transformer-big.

Its loss, gradients and first AdamW moment, gathered, equal the
unpartitioned port step's (loss rtol 1e-6; gradients and moment atol
1e-6, rtol 1e-5: the shards sum f32 products in another order), and its
loss and gradients the reference's ``model.loss(remat=True)`` and
``jax.grad`` at the family tolerance of tests/test_torch_model.py (loss
rtol 1e-5; gradients atol 1e-5, rtol 1e-4).  The
updated parameters equal the unpartitioned step's to 1e-6 wherever the
gradient is clear of that rounding (|g| > 1e-5); at AdamW's first step
the update is lr * g / (|g| + eps), which turns the sign of a gradient
within rounding of zero, so there the two steps may part by at most
2 lr.  Collectives cross both mesh dims.
"""

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.models import build_model as jbuild_model           # noqa: E402
from repro.configs import get_config as jget_config            # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.training import (grad_contributions,           # noqa: E402
                                  make_train_step)
from repro_torch.tree import tree_flatten                       # noqa: E402

import _torch_dist_worker as W                                 # noqa: E402
from _torch_world import spawn_world                           # noqa: E402

jax.config.update("jax_platform_name", "cpu")

WORLD = 4
KW = dict(attn_impl="chunked", loss_chunk=8, remat=True)
TOL = dict(atol=1e-6, rtol=1e-5)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("partitioned_world")
    spawn_world(W.run_partitioned, WORLD, out, timeout=240)
    return torch.load(out / "rank0.pt")


def _unpartitioned(arch):
    model, params, batch = W.partitioned_inputs(arch)
    opt = W.partitioned_optimizer(model)
    grads, loss, _ = grad_contributions(model, params, batch, **KW)
    state = opt.init(params)
    new_p, new_o, _, _ = make_train_step(model, opt, **KW)(
        params, state, opt.init_exchange_state(grads), batch)
    return loss, grads, new_p, new_o, params, batch


@pytest.mark.parametrize("arch", W.PARTITIONED_ARCHS)
def test_partitioned_step_equals_the_unpartitioned_one(arch, results):
    got = results[arch]
    loss, grads, new_p, new_o, _, _ = _unpartitioned(arch)
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-6)
    assert torch.equal(got["loss"], got["step_loss"])
    pairs = [(got["grads"], grads), (got["mu"], new_o.mu)]
    for mine, want in pairs:
        for a, b in zip(tree_flatten(mine)[0], tree_flatten(want)[0]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    for a, b, g in zip(tree_flatten(got["params"])[0],
                       tree_flatten(new_p)[0], tree_flatten(grads)[0]):
        clear = g.abs() > 1e-5
        np.testing.assert_allclose(a[clear].numpy(), b[clear].numpy(),
                                   atol=1e-6, rtol=0)
        assert float((a - b).abs().max()) <= 2 * _first_lr(arch) + 1e-7
    assert got["sharded"] > 0
    assert set(got["counts"]) == {"data", "model"}
    assert got["counts"]["data"].get("reduce_scatter", 0) > 0  # FSDP grads


def _first_lr(arch) -> float:
    model = W.partitioned_inputs(arch)[0]
    d = model.cfg.d_model
    return 2.0 * d ** -0.5 * 10 ** -1.5      # Noam at step 1, warmup 10


@pytest.mark.parametrize("arch", W.PARTITIONED_ARCHS)
def test_partitioned_step_matches_the_reference(arch, results):
    got = results[arch]
    _, params, batch = W.partitioned_inputs(arch)
    jmodel = jbuild_model(jget_config(arch).reduced())
    jparams = jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(params))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: jmodel.loss(p, bb, loss_chunk=8, remat=True)[0]))(
            jparams, jbatch)
    np.testing.assert_allclose(float(got["loss"]), float(jloss), rtol=1e-5)
    for a, b in zip(tree_flatten(got["grads"])[0],
                    jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-4)
