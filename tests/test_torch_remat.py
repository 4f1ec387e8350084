"""Remat (``Model.loss(remat=True)``) against the plain loss and against
the reference's ``jax.checkpoint``, one reduced config of each family in
f32 on the CPU.

  * the port's loss and gradients under ``remat=True`` equal its
    ``remat=False`` ones bitwise (the backward recomputes each unit with
    the same ops on the same inputs);
  * they equal the reference's ``model.loss(..., remat=True)`` and its
    ``jax.grad`` at the family tolerance of tests/test_torch_model.py
    (loss rtol 1e-5; gradients atol 1e-5, rtol 1e-4: XLA and torch sum
    in different orders);
  * FLOPs: the port's counter on the remat loss-plus-backward equals the
    reference's jaxpr walked into ``remat``/``checkpoint`` (the walker of
    tests/test_torch_flops.py) product by product for the families that
    file finds equal without remat; in every family the recompute adds
    exactly the forward's products (each unit recomputed once);
  * both gradient paths take ``remat=True`` bitwise: the sparse-embedding
    tap, and the wait-free per-block hooks, where the stacked layers'
    hook fires once, after the last recompute;
  * the forward-only kernel route refuses remat.

The reference side runs jitted with XLA's optimisation turned down
(tests/test_torch_microbatch.py's ``jit_fast``).
"""
import collections

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

import test_torch_flops as tflops                               # noqa: E402
from test_torch_microbatch import jit_fast                      # noqa: E402
from repro.configs import get_config as jget_config            # noqa: E402
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.models.model import Model as JModel                 # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.core import DistributedOptimizer, ExchangeConfig  # noqa
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.models import model as model_mod               # noqa: E402
from repro_torch.models.model import Model                      # noqa: E402
from repro_torch.optim import adamw                             # noqa: E402
from repro_torch.training import gradients, make_train_step     # noqa: E402
from repro_torch.tree import tree_flatten, tree_unflatten       # noqa: E402

jax.config.update("jax_platform_name", "cpu")

FAMILIES = {"dense": "deepseek-7b", "audio": "transformer-big",
            "moe": "llama4-scout-17b-a16e", "hybrid": "zamba2-7b",
            "ssm": "xlstm-125m", "vlm": "internvl2-1b"}
B, S = 2, 8
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)          # tests/test_torch_model.py


def _batch(cfg):
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.frontend is not None:
        batch["frontend"] = rng.standard_normal(
            (B, cfg.frontend.n_embeds, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=list(FAMILIES.values()),
                ids=list(FAMILIES))
def family(request):
    arch = request.param
    model = build_model(get_config(arch).reduced())
    params = model.init(seed=0, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(params))
    jmodel = jbuild_model(jget_config(arch).reduced())
    return arch, jmodel, jparams, model, params, _batch(model.cfg)


def _loss_and_grads(model, params, batch, **kw):
    leaves, treedef = tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = model.loss(tree_unflatten(treedef, leaves), tbatch, **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, [torch.zeros_like(x) if g is None else g
                  for x, g in zip(leaves, grads)]


def test_remat_is_bitwise_the_plain_loss(family):
    _, _, _, model, params, batch = family
    loss, grads = _loss_and_grads(model, params, batch)
    rloss, rgrads = _loss_and_grads(model, params, batch, remat=True)
    assert torch.equal(loss, rloss)
    assert all(torch.equal(a, b) for a, b in zip(grads, rgrads))
    with pytest.raises(ValueError, match="forward only"):
        model.loss(params, {k: torch.from_numpy(v) for k, v in
                            batch.items()}, attn_impl="kernel", remat=True)


def test_remat_matches_the_reference(family):
    _, jmodel, jparams, model, params, batch = family
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jit_fast(jax.value_and_grad(
        lambda p, bb: jmodel.loss(p, bb, remat=True)[0]), jparams, jbatch)
    loss, grads = _loss_and_grads(model, params, batch, remat=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD_TOL)


# ---------------------------------------------------------------------------
# FLOPs: the recompute, counted on both sides
# ---------------------------------------------------------------------------

class _JRemat(JModel):
    def loss(self, params, batch, **kw):
        return super().loss(params, batch, remat=True, **kw)


class _Remat(Model):
    def loss(self, params, batch, **kw):
        return super().loss(params, batch, remat=True, **kw)


def _forward_products(cfg, b, s):
    """The port's forward (embedding, blocks, final norm: the blocks hold
    every product) on meta tensors."""
    model = build_model(cfg)
    batch = {"tokens": tflops.meta(b, s, dtype=torch.int32)}
    if cfg.frontend is not None:
        batch["frontend"] = tflops.meta(b, cfg.frontend.n_embeds,
                                        cfg.d_model)
    with tflops._Listing() as c:
        model.forward(model.init(device="meta"), batch)
    return c.result()["product_flops"]


@pytest.mark.parametrize("arch", list(tflops.FAMILIES) + ["internvl2-1b"])
def test_remat_flops(arch, monkeypatch):
    b, s = tflops.FAMILY_SHAPES.get(arch, (2, 64))
    cfg = get_config(arch).reduced()
    plain = tflops.port_products(cfg, b, s)[1]["product_flops"]
    monkeypatch.setattr(tflops, "build_model", lambda c: _Remat(cfg=c))
    each, remat = tflops.port_products(cfg, b, s)
    # the recompute adds at most one forward: torch's checkpoint stops
    # once the tensors the backward needs are back, so a unit's last
    # product (whose output nothing saved) is not redone
    assert plain < remat["product_flops"] <= plain + _forward_products(
        cfg, b, s)
    if tflops.FAMILIES.get(arch) != ({}, ()):
        return
    monkeypatch.setattr(tflops, "jbuild_model", lambda c: _JRemat(cfg=c))
    ref = tflops.reference_products(arch, b, s)
    ref_each = collections.Counter()
    for (f, _), n in ref.items():
        ref_each[f] += n
    assert each == ref_each
    assert remat["product_flops"] == sum(f * n for (f, _), n in ref.items())


# ---------------------------------------------------------------------------
# The gradient paths
# ---------------------------------------------------------------------------

def test_sparse_tap_takes_remat():
    model = build_model(get_config("transformer-big").reduced())
    params = model.init(seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    outs = [gradients.grad_contributions(model, params, batch,
                                         sparse_embedding=True, remat=r)
            for r in (False, True)]
    (g0, l0, _), (g1, l1, _) = outs
    assert torch.equal(l0, l1)
    s0, dense0 = g0["embedding"]
    s1, dense1 = g1["embedding"]
    assert torch.equal(s0.indices, s1.indices)
    assert torch.equal(s0.values, s1.values) and torch.equal(dense0, dense1)
    for a, b in zip(tree_flatten({k: v for k, v in g0.items()
                                  if k != "embedding"})[0],
                    tree_flatten({k: v for k, v in g1.items()
                                  if k != "embedding"})[0]):
        assert torch.equal(a, b)


def test_wait_free_hooks_fire_once_after_the_recompute(monkeypatch):
    model = build_model(get_config("transformer-big").reduced())
    params = model.init(seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    opt = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
        sparse_as_dense=True, overlap="backward"))
    events = []
    block, hook = model_mod._block, gradients.backward_hook

    def logged_block(*a, **k):
        events.append("block")
        return block(*a, **k)

    def logged_hook(bwd_fn):
        def run(g):
            events.append(("hook", tuple(sorted(g)) if isinstance(g, dict)
                           else ()))
            return bwd_fn(g)
        return hook(run)
    monkeypatch.setattr(model_mod, "_block", logged_block)
    monkeypatch.setattr(gradients, "backward_hook", logged_hook)
    out = {}
    for remat in (False, True):
        events.clear()
        grads = gradients.abstract_grad_contributions(model, params, batch)
        step = make_train_step(model, opt, remat=remat)
        out[remat] = step(params, opt.init(params),
                          opt.init_exchange_state(grads, device="cpu"),
                          batch)
    n = model.cfg.n_layers
    layer_hooks = [i for i, e in enumerate(events)
                   if isinstance(e, tuple) and "attn" in e[1]]
    blocks = [i for i, e in enumerate(events) if e == "block"]
    assert len(blocks) == 2 * n            # the forward, then the recompute
    assert len(layer_hooks) == 1 and layer_hooks[0] > blocks[-1]
    for a, b in zip(tree_flatten(out[False][0])[0],
                    tree_flatten(out[True][0])[0]):
        assert torch.equal(a, b)
    assert torch.equal(out[False][3]["loss"], out[True][3]["loss"])
