"""The port's ZeRO-1 across a gloo world of 4, spawned once
(``_torch_dist_worker.run_zero1``), against the port's replicated step
and the reference's 4-device ``shard_map`` run:

  * every rank holds only its local state, of
    ``optimizer_state_bytes(plan, 4)`` bytes, and issues the plan's
    ``hlo_collectives(4)`` collective calls a step;
  * 3 zero1 steps with identity, bf16, int8 and int8+ef bitwise the
    replicated exchange + update on the same gradients (the reference's
    own claim, ``tests/test_zero1.py``), moments through the bucket
    layout; the ring simulation's zero1 step (its reduce-scatter must
    leave rank r with chunk r) within f32 noise of the flat one;
  * the ranks' shards after one step, written by ``ShardedCheckpoint``
    as the global view, equal the reference's global ``Zero1State`` (and
    residuals) from a subprocess on 4 emulated devices, restored from
    the reference's own checkpoint file;
  * a resume after step 2 through ``ShardedCheckpoint`` bitwise equal to
    4 uninterrupted steps.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np                            # noqa: E402

from repro_torch.checkpoint import restore_checkpoint          # noqa: E402
from repro_torch.checkpoint.checkpoint import flatten_with_paths  # noqa: E402

import _torch_dist_worker as W                                  # noqa: E402
from _torch_world import spawn_world                            # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4

#: the reference's one zero1 step on 4 emulated devices, written as its
#: own checkpoint of the global (params, Zero1State, ExchangeState)
REFERENCE = r"""
import functools, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.checkpoint import save_checkpoint
from repro.core import DistributedOptimizer, ExchangeConfig
from repro.optim import adamw
from repro.optim import zero1 as z1

out, configs = sys.argv[1], eval(sys.argv[2])
d = np.load(out + "/inputs.npz")
mesh = Mesh(np.array(jax.devices()).reshape(4), ("data",))
params = {"a": jnp.asarray(d["a"]), "b": jnp.asarray(d["b"])}
ga, gb = jnp.asarray(d["ga"]), jnp.asarray(d["gb"])
gabs = {"a": jax.ShapeDtypeStruct(ga.shape[1:], jnp.float32),
        "b": jax.ShapeDtypeStruct(gb.shape[1:], jnp.float32)}
base = adamw(lr=1e-2, weight_decay=0.01)
for name, kw in configs.items():
    opt = DistributedOptimizer(base, exchange=ExchangeConfig(
        zero1=True, sparse_as_dense=True, use_kernel=True, **kw),
        axis_name="data")
    z0 = opt.init_zero1_state(gabs, params, n_workers=4)
    zspec = z1.state_specs(opt.plan(gabs), z0, "data")
    ex0 = opt.init_exchange_state(gabs, n_workers=4)
    exspec = jax.tree_util.tree_map(lambda _: P("data"), ex0)

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(), zspec, exspec, (P("data"), P("data"))),
                       out_specs=(P(), zspec, exspec), check_rep=False)
    def step(p, z, e, g):
        return opt.zero1_step({"a": g[0][0], "b": g[1][0]}, p, z,
                              exchange_state=e)

    save_checkpoint(out + "/ref_" + name, 1, step(params, z0, ex0,
                                                  (ga, gb)))
print("OK")
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results and the reference's files: the reference's
    subprocess runs while the gloo world does."""
    out = tmp_path_factory.mktemp("zero1_world")
    rng = np.random.default_rng(0)
    np.savez(out / "inputs.npz",
             a=rng.standard_normal((16, 8)).astype(np.float32),
             b=rng.standard_normal(37).astype(np.float32),
             ga=rng.standard_normal((WORLD, 16, 8)).astype(np.float32),
             gb=rng.standard_normal((WORLD, 37)).astype(np.float32))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(out),
         repr(W.ZERO1_REFERENCE)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    spawn_world(W.run_zero1, WORLD, out, timeout=240)
    stdout, stderr = ref.communicate(timeout=240)
    assert ref.returncode == 0, stderr[-4000:]
    assert "OK" in stdout
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, out


def test_each_rank_holds_its_local_state(world):
    ranks, _ = world
    for res in ranks:
        for name in W.ZERO1_CONFIGS:
            assert res[f"{name}/nbytes"] == res[f"{name}/expected_nbytes"]
            assert res[f"{name}/calls"] == [res[f"{name}/plan_calls"]] \
                * W.ZERO1_STEPS
    # a quarter of the padded dense EMA (+ the step counter), not all of it
    full = 2 * 4 * (16 * 8 + 37)
    assert ranks[0]["identity/nbytes"] < full // 2


@pytest.mark.parametrize("name", ["identity", "bf16", "int8", "int8+ef"])
def test_zero1_bitwise_replicated(world, name):
    ranks, _ = world
    for res in ranks:
        for a, b in zip(res[f"{name}/zero1"], res[f"{name}/replicated"]):
            assert torch.equal(a, b)
        for slots, mu in zip(res[f"{name}/zero1_slots"],
                             res[f"{name}/replicated_mu"]):
            assert torch.equal(slots[0], mu)
    # the replicated params agree on every rank
    for res in ranks[1:]:
        for a, b in zip(res[f"{name}/zero1"], ranks[0][f"{name}/zero1"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("codec", ["identity", "int8+ef"])
def test_ringsim_zero1_shards_in_rank_order(world, codec):
    """The ring's reduce-scatter sums in another order than the flat
    one, so the two agree within f32 noise, not bitwise; a shard landing
    on the wrong rank would be off by the gradients themselves."""
    ranks, _ = world
    for res in ranks:
        for a, b in zip(res[f"ringsim/{codec}/zero1"], res[f"{codec}/zero1"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)
        for sa, sb in zip(res[f"ringsim/{codec}/zero1_slots"],
                          res[f"{codec}/zero1_slots"]):
            np.testing.assert_allclose(sa[0].numpy(), sb[0].numpy(),
                                       rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("name", sorted(W.ZERO1_REFERENCE))
def test_global_state_equals_reference(world, name):
    """The ranks' gathered shards (the file rank 0 wrote) against the
    reference's global state (its own file, restored by the port),
    leaf by leaf; each rank's slice of it is that rank's local state."""
    ranks, out = world
    ours = str(out / f"global_{name}")
    like, _ = restore_checkpoint(ours, _template(ranks[0][f"ref/{name}"]))
    theirs, step = restore_checkpoint(str(out / f"ref_{name}"), like)
    assert step == 1
    got, want = flatten_with_paths(like), flatten_with_paths(theirs)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert any("param_shards" in k for k, _ in got) == (
        "param_int8" in name)
    for (key, a), (_, b) in zip(got, want):
        tol = dict(rtol=1e-5, atol=1e-7)
        if "#2/" in key or key.startswith("#0/"):
            tol = dict(rtol=1e-5, atol=1e-6)     # residuals, params
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=key, **tol)
    # rank r's local state is chunk r of the global view
    for r, res in enumerate(ranks):
        _, z, ex = res[f"ref/{name}"]
        for k, slot in enumerate(z.opt_slots):
            n = slot[0].shape[0]
            full = like[1].opt_slots[k][0]
            assert torch.equal(slot[0], full[r * n:(r + 1) * n])
        for k, s in enumerate(ex.bucket_states):
            if isinstance(s, torch.Tensor):
                n = s.shape[0]
                full = like[2].bucket_states[k]
                assert torch.equal(s, full[r * n:(r + 1) * n])


def _template(tree):
    """Empty tensors of the global view's shapes for a rank's (params,
    Zero1State, ExchangeState) of the all-dense plan: Zero1State
    entries and residuals are P slices wide."""
    from repro_torch.checkpoint.checkpoint import _unflatten
    out = []
    for key, t in flatten_with_paths(tree):
        sliced = key.startswith(("#1/@opt_slots", "#1/@param_shards", "#2/"))
        out.append(torch.empty((WORLD * t.shape[0],) if sliced
                               else t.shape, dtype=t.dtype))
    return _unflatten(tree, iter(out))


def test_resume_bitwise(world):
    ranks, _ = world
    for res in ranks:
        assert res["resume/step"] == 2
        got = flatten_with_paths(res["resume/resumed"])
        want = flatten_with_paths(res["resume/whole"])
        assert [k for k, _ in got] == [k for k, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert torch.equal(a, b)
        assert int(res["resume/resumed"][1].step) == 4
