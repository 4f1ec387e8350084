"""The port's overlapped exchange (staged and wait-free) against the JAX
package's plan and against its own fused path.

  * ``ExchangeConfig.overlap`` normalises as the reference's
    (``tests/test_wait_free.py``), and a plan under ``"backward"`` snaps
    its buckets to top-level blocks: layout, schedule and triggers equal
    the reference's exactly, with a fusion threshold that would otherwise
    merge across blocks; ``backward_block_stages`` equals the
    reference's.  ``Model.grad_blocks`` is the reference's.
  * ``execute_scheduled`` is bitwise ``execute_fused`` for the identity,
    bf16, int8 and int8+ef wires (residuals included), and
    ``wait_free_grad_exchange`` is bitwise the fused exchange of
    ``grad_contributions``, sparse embedding off and on, with its hooked
    stages launched inside the backward pass.
  * The launcher's ``--overlap staged|backward`` trains bitwise as the
    fused launcher (parameters, Adam state, residuals), and so does a
    gloo world of 2, where every rank also holds the same parameters.
  * The loss-scaled step: at M = 1 its three paths are bitwise equal; at
    M = 4 staged and backward are bitwise equal, and fused (which sums
    the fourth microbatch before the exchange, not inside it) agrees
    with them at the reference test's rtol 1e-5, atol 1e-7 (parameters,
    Adam moments, residuals; identity and int8+ef).

Every other comparison here is bitwise: both paths run the same
per-stage ops on the same gradients.
"""
import gc

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402
import torch.distributed as dist              # noqa: E402

import _torch_dist_worker                     # noqa: E402
from _torch_world import spawn_world           # noqa: E402
from repro.configs import get_config as jget_config          # noqa: E402
from repro.core import (DistributedOptimizer as JDistOpt,    # noqa: E402
                        ExchangeConfig as JExchangeConfig)
from repro.data import make_pipeline as jmake_pipeline         # noqa: E402
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.optim import adamw as jadamw                        # noqa: E402
from repro.training.gradients import (                         # noqa: E402
    abstract_grad_contributions)
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.core import (DistributedOptimizer,             # noqa: E402
                              ExchangeConfig, comm)
from repro_torch.launch import train                            # noqa: E402
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.models.layers import backward_hook             # noqa: E402
from repro_torch.optim import adamw                             # noqa: E402
from repro_torch.training import (grad_contributions,           # noqa: E402
                                  wait_free_grad_exchange)
from repro_torch.tree import tree_flatten                       # noqa: E402

jax.config.update("jax_platform_name", "cpu")

BIG = 1 << 40


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("transformer-big").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_batch = jmake_pipeline(jcfg, 2, 16, seed=0).batch_at(0)
    model = build_model(get_config("transformer-big").reduced())
    params = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in np_batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    return jmodel, jparams, jbatch, model, params, batch


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def bitwise(a, b) -> bool:
    """Two lists (or trees) of tensors, equal dtype and bits."""
    la = a if isinstance(a, list) else tree_flatten(a)[0]
    lb = b if isinstance(b, list) else tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


def _residuals(ex):
    return [s for s in ex.bucket_states if isinstance(s, torch.Tensor)]


def _layout(plan):
    return (tuple((b.wire_dtype, b.n_elems,
                   tuple((s.leaf_idx, s.offset, s.size) for s in b.slots))
                  for b in plan.dense_buckets),
            tuple(plan.dense_leaf_ids), tuple(plan.gather_leaf_ids),
            tuple((s.kind, s.bucket_id, tuple(s.leaf_ids), s.trigger)
                  for s in plan.schedule.stages),
            tuple(plan.leaf_blocks), plan.n_collectives,
            tuple(plan.wire_bytes(p) for p in (2, 8)))


def test_overlap_mode_normalization():
    """tests/test_wait_free.py::test_overlap_mode_normalization."""
    assert ExchangeConfig().overlap is False
    assert ExchangeConfig(overlap=None).overlap is False
    assert ExchangeConfig(overlap="off").overlap is False
    assert ExchangeConfig(overlap=True).overlap == "staged"
    assert ExchangeConfig(overlap="staged").overlap == "staged"
    assert ExchangeConfig(overlap="backward").overlap == "backward"
    assert ExchangeConfig(overlap="backward").overlap_backward
    assert not ExchangeConfig(overlap="staged").overlap_backward
    assert ExchangeConfig(overlap=True) == ExchangeConfig(overlap="on")
    with pytest.raises(ValueError, match="unknown overlap mode"):
        ExchangeConfig(overlap="sideways")


@pytest.mark.parametrize("sparse,accum", [
    (False, dict(sparse_as_dense=True)),
    (True, dict(sparse_as_dense=True)),
    (True, dict()),
    (True, dict(algorithm="proposed_algorithm2", codec="int8+ef"))])
def test_backward_plan_matches_reference(setup, sparse, accum):
    """With a threshold that fuses every leaf into one bucket, the
    staged plan has one dense bucket and the backward plan one per
    block; both equal the reference's exactly, and so does the split
    into hooked and tail stages."""
    jmodel, jparams, jbatch, model, params, batch = setup
    jg = abstract_grad_contributions(jmodel, jparams, jbatch,
                                     sparse_embedding=sparse)
    g = grad_contributions(model, params, batch, sparse_embedding=sparse)[0]
    hooked_blocks = set(params) - ({"embedding"} if sparse else set())
    for overlap in ("staged", "backward"):
        kw = dict(fusion_threshold=BIG, overlap=overlap, **accum)
        jplan = JDistOpt(jadamw(1e-3), exchange=JExchangeConfig(**kw),
                         axis_name=None).plan(jg)
        plan = DistributedOptimizer(adamw(1e-3),
                                    exchange=ExchangeConfig(**kw)).plan(g)
        assert _layout(plan) == _layout(jplan)
        assert plan.backward_block_stages(hooked_blocks) == \
            jplan.backward_block_stages(hooked_blocks)
        assert plan.backward_block_stages() == jplan.backward_block_stages()
        if overlap == "staged":
            assert len(plan.dense_buckets) == 1
        else:
            for st in plan.schedule.stages:
                blocks = {plan.leaf_blocks[i] for i in st.leaf_ids}
                assert blocks == {st.trigger}
            assert len(plan.dense_buckets) == len(
                {plan.leaf_blocks[i] for i in plan.dense_leaf_ids})
    assert model.grad_blocks(params) == jmodel.grad_blocks(jparams)


def test_backward_hook_is_an_identity_that_sees_the_whole_block():
    calls = []

    def bwd(g_block):
        calls.append({k: v.clone() for k, v in g_block.items()})

    # small integers: every sum is exact in any order of accumulation
    a = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
    b = torch.tensor([4.0, 5.0, -6.0], requires_grad=True)
    c = torch.tensor([-7.0, 8.0, 9.0], requires_grad=True)
    block = backward_hook(bwd)({"a": a, "b": b})
    assert torch.equal(block["a"], a) and torch.equal(block["b"], b)
    loss = (block["a"] * block["b"]).sum() + block["a"].sum() \
        + (block["a"] * c).sum()
    ga, gb, gc = torch.autograd.grad(loss, [a, b, c], allow_unused=True)
    assert len(calls) == 1            # once, with both leaves' gradients
    assert torch.equal(calls[0]["a"], b.detach() + 1 + c.detach())
    assert torch.equal(calls[0]["b"], a.detach())
    assert ga is None and gb is None  # the hook hands nothing on
    assert torch.equal(gc, a.detach())


def test_async_collectives_pass_through_on_the_local_path():
    """The local path passes tensors through; ``wait`` returns them."""
    x = torch.arange(4.0)
    assert comm.all_reduce_dense(x, None) is x
    assert comm.wait(x) is x


@pytest.mark.parametrize("codec", ["identity", "bf16", "int8", "int8+ef"])
@pytest.mark.parametrize("accum", ["dense_reduce", "sparse_gather"])
def test_scheduled_is_bitwise_fused(setup, codec, accum):
    _, _, _, model, params, batch = setup
    g = grad_contributions(model, params, batch, sparse_embedding=True)[0]
    kw = dict(sparse_as_dense=accum == "dense_reduce", codec=codec,
              use_kernel=True)
    fused = DistributedOptimizer(adamw(1e-3),
                                 exchange=ExchangeConfig(**kw))
    staged = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
        overlap="staged", **kw))
    sf, ss = (fused.init_exchange_state(g), staged.init_exchange_state(g))
    for _ in range(2):       # the second exchange reads the residuals
        tf, sf = fused.exchange(g, state=sf)
        ts, ss = staged.exchange(g, state=ss)
        assert bitwise(ts, tf)
        assert bitwise(_residuals(ss), _residuals(sf))
    assert len(_residuals(sf)) == (0 if codec != "int8+ef" else
                                   sum(s.kind == "dense" for s in
                                       fused.plan(g).schedule.stages))
    assert bitwise(staged.exchange_fused(g, state=staged.init_exchange_state(
        g))[0], fused.exchange_scheduled(g, state=fused.init_exchange_state(
            g))[0])


@pytest.mark.parametrize("codec", ["identity", "int8+ef"])
@pytest.mark.parametrize("sparse", [False, True])
def test_wait_free_is_bitwise_fused(setup, monkeypatch, sparse, codec):
    _, _, _, model, params, batch = setup
    kw = dict(sparse_as_dense=True, codec=codec, use_kernel=True)
    fused = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(**kw))
    wf = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
        overlap="backward", **kw))
    g, loss, _ = grad_contributions(model, params, batch,
                                    sparse_embedding=sparse)
    want, sf = fused.exchange(g, state=fused.init_exchange_state(g))

    plan = wf.plan(g)
    launched_in_backward = {}
    real = type(plan).launch_stage

    def launch(self, stage, *a, **k):
        # a backward pass is running when autograd has a graph task
        launched_in_backward[stage] = \
            torch._C._current_graph_task_id() != -1
        return real(self, stage, *a, **k)
    monkeypatch.setattr(type(plan), "launch_stage", launch)
    got, sw, wloss, metrics = wait_free_grad_exchange(
        model, wf, params, batch, state=wf.init_exchange_state(g),
        sparse_embedding=sparse)
    assert bitwise(got, want)
    assert bitwise(_residuals(sw), _residuals(sf))
    assert float(wloss) == float(loss)
    assert int(metrics["exchange_stages"]) == plan.schedule.n_stages
    hooked, tail = plan.backward_block_stages(
        set(params) - ({"embedding"} if sparse else set()))
    stages = plan.schedule.stages
    assert len(launched_in_backward) == len(stages)
    for sid, st in enumerate(stages):
        assert launched_in_backward[st] == (sid not in tail)
    assert ("embedding" in hooked) != sparse


def _states(result):
    return (tree_flatten(result["params"])[0]
            + tree_flatten(result["opt_state"].mu)[0]
            + tree_flatten(result["opt_state"].nu)[0]
            + [result["opt_state"].step]
            + _residuals(result["exchange_state"]))


@pytest.mark.parametrize("codec", [[], ["--codec", "int8",
                                        "--error-feedback"]])
def test_launcher_overlap_is_bitwise_fused(codec):
    argv = ["--reduced", "--dist", "horovod", "--grad-accum",
            "dense_reduce", "--batch-per-worker", "2", "--seq-len", "16",
            "--steps", "3", "--log-every", "1", "--device", "cpu"] + codec
    quiet = lambda s: None
    fused = train.run(argv, log=quiet)
    for overlap in (["--overlap"], ["--overlap", "backward"]):
        assert train.parse_args(argv + overlap).overlap == overlap[-1] \
            if len(overlap) == 2 else "staged"
        res = train.run(argv + overlap, log=quiet)
        assert [h["loss"] for h in res["history"]] == \
            [h["loss"] for h in fused["history"]]
        assert bitwise(_states(res), _states(fused))
    assert not dist.is_initialized()
    assert train.parse_args(argv).overlap is None


def test_gloo_world_of_two_overlap_is_bitwise_fused(tmp_path):
    spawn_world(_torch_dist_worker.run_overlap, 2, tmp_path, timeout=240)
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for prefix in ("", "scaled/"):
        for codec in ("identity", "int8+ef"):
            fused = f"{prefix}{codec}/False"
            for r in range(2):
                for overlap in ("staged", "backward"):
                    tag = f"{prefix}{codec}/{overlap}"
                    for what in ("params", "mu", "nu", "residuals"):
                        assert bitwise(res[r][f"{tag}/{what}"],
                                       res[r][f"{fused}/{what}"]), \
                            (r, tag, what)
            # every rank applied the same averaged gradient
            assert bitwise(res[0][f"{fused}/params"],
                           res[1][f"{fused}/params"])
            n_res = len(res[0][f"{fused}/residuals"])
            assert n_res == (16 if codec == "int8+ef" else 0)


def _scaled_states(model, params, batch, codec, n):
    """One loss-scaled step of each overlap mode from the same start."""
    from repro_torch.training import LossScaler, make_scaled_train_step
    from repro_torch.training.microbatch import _scale_grad_tree
    out = {}
    for overlap in (False, "staged", "backward"):
        opt = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
            sparse_as_dense=True, codec=codec, overlap=overlap,
            use_kernel=True))
        step = make_scaled_train_step(model, opt, LossScaler(),
                                      n_microbatches=n,
                                      sparse_embedding=True)
        g = grad_contributions(model, params, batch,
                               sparse_embedding=True)[0]
        ex = opt.init_exchange_state(_scale_grad_tree(g, torch.ones(())))
        p, st, ss, ex, m = step(params, opt.init(params),
                                LossScaler().init(device="cpu"), ex, batch)
        assert not bool(m["overflow"])
        out[overlap] = (tree_flatten(p)[0], tree_flatten(st.mu)[0]
                        + tree_flatten(st.nu)[0] + [st.step],
                        _residuals(ex), float(m["loss"]))
    return out


@pytest.mark.parametrize("codec", ["identity", "int8+ef"])
def test_scaled_step_overlap_paths(setup, codec):
    """At M = 1 the three paths are one computation (bitwise).  At M = 4
    fused sums all four microbatches before the exchange while staged and
    backward defer the last one into it, so, as in the reference
    (tests/test_microbatch.py, tests/test_wait_free.py), staged and
    backward are bitwise equal and fused agrees with them within the f32
    rounding of that sum: parameters, Adam moments and error-feedback
    residuals rtol 1e-5, atol 1e-7, the reference test's tolerance, on
    both wires."""
    _, _, _, model, params, _ = setup
    np_batch = jmake_pipeline(jget_config("transformer-big").reduced(), 4, 8,
                              seed=0).batch_at(0)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in np_batch.items()}
    one = _scaled_states(model, params, batch, codec, 1)
    for mode in ("staged", "backward"):
        for a, b in zip(one[mode][:3], one[False][:3]):
            assert bitwise(a, b), mode
        assert one[mode][3] == one[False][3]
    four = _scaled_states(model, params, batch, codec, 4)
    for a, b in zip(four["backward"][:3], four["staged"][:3]):
        assert bitwise(a, b)
    assert four["backward"][3] == four["staged"][3] == four[False][3]
    # parameters, Adam moments and (int8+ef) residuals
    for got, want in zip(four["staged"][:3], four[False][:3]):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("overlap", [False, "staged", "backward"])
def test_scaled_step_leaves_no_tensor_in_a_reference_cycle(setup, overlap):
    """A step's gradients are freed when it returns, not when Python's
    cyclic collector next runs (on the card they are gigabytes)."""
    from repro_torch.training import LossScaler, make_scaled_train_step
    from repro_torch.training.microbatch import _scale_grad_tree
    _, _, _, model, params, batch = setup
    opt = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
        sparse_as_dense=True, codec="int8+ef", overlap=overlap,
        use_kernel=True))
    step = make_scaled_train_step(model, opt, LossScaler(),
                                  n_microbatches=2, sparse_embedding=True)
    g = grad_contributions(model, params, batch, sparse_embedding=True)[0]
    ex = opt.init_exchange_state(_scale_grad_tree(g, torch.ones(())))
    state = (params, opt.init(params), LossScaler().init(device="cpu"), ex)
    del g
    gc.collect()
    gc.disable()
    try:
        out = step(*state, batch)
        del out
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not cyclic, [tuple(t.shape) for t in cyclic[:5]]

