"""The port's collective backends across gloo worlds of 4 (2 x 2 pods)
and 8 (2 x 4), each spawned once (``_torch_dist_worker.run_backends``),
against the reference:

  * averaging on the flat, hierarchical and ring backends equal to the
    mean of the reference's local exchanges (worlds of 4 and 8);
  * the hierarchical int8 and int8+ef exchanges (two in a row) hop by hop:
    every dense stage's gathered q and scales bitwise equal to the
    reference's ``encode_hop`` per worker, ``reduce_hop`` per pod,
    requantize and ``reduce_hop`` across pods; results within 1e-6;
  * the ring: allreduce bitwise equal to a numpy replay of the
    reference's chunk order, reduce-scatter and allgather in its shard
    order, and fp8 rings bitwise equal to the reference's cast-add-cast
    (a pair and the world of 4);
  * reduce-scatter + allgather against the flat allreduce (identity
    within 1e-6, bf16 within the reference's 2% of the largest value);
  * the comm layer's call counters of every exchange equal to
    ``plan.hlo_collectives(levels)``;
  * staged and wait-free steps bitwise equal to the fused step on every
    backend (the reduced transformer-big, identity and int8+ef).
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.core import (DistributedOptimizer as JDistOpt,    # noqa: E402
                        ExchangeConfig as JExchangeConfig,
                        exchange as jexchange)
from repro.core.indexed_slices import IndexedSlices as JSlices  # noqa: E402
from repro.optim import adamw as jadamw                        # noqa: E402
from repro_torch.core.indexed_slices import IndexedSlices as TSlices  # noqa: E402

import _torch_dist_worker as W                                  # noqa: E402
from _torch_world import spawn_world                             # noqa: E402

jax.config.update("jax_platform_name", "cpu")

LEAVES = ("embedding", "w", "b")
F8 = {"f8e4m3": jnp.float8_e4m3fn, "f8e5m2": jnp.float8_e5m2}


def _spawn(world: int, out):
    spawn_world(W.run_backends, world, out, timeout=240)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(4, tmp_path_factory.mktemp("backends4"))


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return _spawn(8, tmp_path_factory.mktemp("backends8"))


def _to_jax(tree):
    """The worker's torch grad tree -> the reference's."""
    def conv(x):
        if isinstance(x, list):
            return [conv(c) for c in x]
        if isinstance(x, TSlices):
            return JSlices(jnp.asarray(x.indices.numpy()),
                           jnp.asarray(x.values.numpy()), x.dense_shape)
        return jnp.asarray(x.numpy())
    return {"embedding": conv(tree["embedding"]),
            "layers": {k: conv(v) for k, v in tree["layers"].items()}}


def _leaves(tree):
    return {"embedding": np.asarray(tree["embedding"]),
            "w": np.asarray(tree["layers"]["w"]),
            "b": np.asarray(tree["layers"]["b"])}


def _reference_mean(world, k):
    """The mean over ranks of the reference's local exchange of each
    rank's gradients (the dense_reduce tree)."""
    opt = JDistOpt(jadamw(1e-3), exchange=JExchangeConfig(
        sparse_as_dense=True, use_kernel=True))
    outs = [_leaves(opt.exchange(_to_jax(W.worker_grads(r, k))))
            for r in range(world)]
    return {leaf: sum(o[leaf] for o in outs) / world for leaf in LEAVES}


def _issued(calls: dict) -> int:
    """Collectives the comm layer issued: ``two_level_all_reduce`` is
    counted through the allreduces it issues."""
    return sum(v for k, v in calls.items() if k != "two_level_all_reduce")


# ---------------------------------------------------------------------------
# counters and averaging
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(W.BACKEND_CONFIGS))
def test_comm_calls_equal_plan_hlo_collectives(world4, name):
    for res in world4:
        for k in range(2):
            calls = res[f"{name}/{k}/calls"]
            assert _issued(calls) == res[f"{name}/{k}/plan_calls"], calls
            if name == "hierarchical/identity":
                # one two-level allreduce a dense stage, two levels each
                assert calls["two_level_all_reduce"] * 2 == \
                    calls["all_reduce_dense"]
            if name.startswith("ringsim"):
                assert calls["ring_shift"] == _issued(calls) > 0


@pytest.mark.parametrize("name", W.WORLD8_CONFIGS)
def test_world_of_8_averages_like_reference(world8, name):
    for k in range(2):
        want = _reference_mean(8, k)
        for res in world8:
            assert _issued(res[f"{name}/{k}/calls"]) == \
                res[f"{name}/{k}/plan_calls"]
            for leaf in LEAVES:
                np.testing.assert_allclose(
                    res[f"{name}/{k}/{leaf}"].numpy(), want[leaf],
                    rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["flat/identity", "hierarchical/identity",
                                  "ringsim/identity"])
def test_world_of_4_averages_like_reference(world4, name):
    for k in range(2):
        want = _reference_mean(4, k)
        for res in world4:
            for leaf in LEAVES:
                np.testing.assert_allclose(
                    res[f"{name}/{k}/{leaf}"].numpy(), want[leaf],
                    rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the hierarchical per-hop requantize, hop by hop
# ---------------------------------------------------------------------------

def _hierarchical_reference(codec_name):
    """Per rank and exchange: the reference's per-hop gathered (q,
    scales) of every dense stage, in schedule order (pod hop, then cross
    hop), and the averaged tree, built from its own functions: hop 0
    ``encode_hop`` per worker (error feedback consumed), ``reduce_hop``
    per pod, the pod sum's stateless requantize, ``reduce_hop`` across
    pods."""
    cfg = JExchangeConfig(backend="hierarchical", codec=codec_name,
                          sparse_as_dense=True, use_kernel=True)
    codec = cfg.codec_obj
    grads = [[_to_jax(W.worker_grads(r, k)) for k in range(2)]
             for r in range(4)]
    plan = jexchange.compile_plan(grads[0][0], cfg)
    states = [list(plan.init_state().bucket_states) for _ in range(4)]
    hops = [[[] for _ in range(2)] for _ in range(4)]
    trees = [[None, None] for _ in range(4)]
    for k in range(2):
        accs = [plan.accumulate(grads[r][k]) for r in range(4)]
        outs = [[None] * plan.n_leaves for _ in range(4)]
        for i, st in enumerate(plan.schedule.stages):
            assert st.kind == "dense"
            bucket = plan.dense_buckets[st.bucket_id]
            enc = []
            for r in range(4):
                q, s, states[r][i] = codec.encode_hop(
                    plan.pack_bucket(bucket, accs[r]), states[r][i], 0,
                    use_kernel=True)
                enc.append((q, s))
            requant = []
            for pod in range(2):
                members = (2 * pod, 2 * pod + 1)
                gq = jnp.concatenate([enc[r][0] for r in members])
                gs = jnp.concatenate([enc[r][1].reshape(-1)
                                      for r in members])
                for r in members:
                    hops[r][k].append((gq, gs))
                partial = codec.reduce_hop(gq, gs, 2, jnp.float32)
                requant.append(codec.encode_hop(partial, (), 1,
                                                use_kernel=True)[:2])
            gq = jnp.concatenate([q for q, _ in requant])
            gs = jnp.concatenate([s.reshape(-1) for _, s in requant])
            final = codec.reduce_hop(gq, gs, 2, jnp.float32)
            for r in range(4):
                hops[r][k].append((gq, gs))
                plan.unpack_bucket(bucket, final, outs[r], 0.25)
        for r in range(4):
            trees[r][k] = _leaves(jax.tree_util.tree_unflatten(
                plan.treedef, outs[r]))
    return hops, trees


@pytest.mark.parametrize("codec", ["int8", "int8+ef"])
def test_hierarchical_int8_matches_reference_hop_by_hop(world4, codec):
    hops, trees = _hierarchical_reference(codec)
    name = f"hierarchical/{codec}"
    for r, res in enumerate(world4):
        for k in range(2):
            got = res[f"{name}/{k}/hops"]
            assert len(got) == len(hops[r][k]) > 0
            for (tq, ts, n), (jq, js) in zip(got, hops[r][k]):
                assert n == 2
                np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
                np.testing.assert_array_equal(ts.numpy().reshape(-1),
                                              np.asarray(js))
            for leaf in LEAVES:
                np.testing.assert_allclose(
                    res[f"{name}/{k}/{leaf}"].numpy(), trees[r][k][leaf],
                    rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["ringsim/int8+ef",
                                  "hierarchical/sparse_gather_int8",
                                  "ringsim/sparse_gather_int8"])
def test_gathers_equal_the_flat_backend_bitwise(world4, name):
    """A ring gather and a per-level gather put every worker's payload
    where the flat allgather does, so the decode-sum is bitwise the flat
    backend's: every leaf on the ring, the gathered embedding on the
    hierarchical backend (its dense stages requantize between levels)."""
    flat = "flat/" + name.split("/")[1]
    leaves = ("embedding",) if name.startswith("hier") else LEAVES
    for res in world4:
        for k in range(2):
            for leaf in leaves:
                assert torch.equal(res[f"{name}/{k}/{leaf}"],
                                   res[f"{flat}/{k}/{leaf}"])


# ---------------------------------------------------------------------------
# the ring, in the reference's chunk order
# ---------------------------------------------------------------------------

def _ring_replay(xs, add, start_offset=0, all_gather=True):
    """The reference ring simulation's schedule over every worker at
    once: P-1 hops where worker r adds its own chunk ``(r + o - s) % P``
    to the one it received from r-1, then (allreduce) P-1 hops passing
    the reduced chunks on."""
    p, n = len(xs), xs[0].shape[0]
    chunk = -(-n // p)
    xp = [np.concatenate([x, np.zeros(p * chunk - n, x.dtype)]
                         ).reshape(p, chunk) for x in xs]
    cur = [xp[r][(r + start_offset) % p] for r in range(p)]
    for s in range(1, p):
        cur = [add(cur[(r - 1) % p], xp[r][(r + start_offset - s) % p])
               for r in range(p)]
    if not all_gather:
        return cur
    out = [np.zeros_like(xp[r]) for r in range(p)]
    for r in range(p):
        out[r][(r + 1) % p] = cur[r]
    for s in range(1, p):
        cur = [cur[(r - 1) % p] for r in range(p)]
        for r in range(p):
            out[r][(r + 1 - s) % p] = cur[r]
    return [o.reshape(-1)[:n] for o in out]


def test_ring_primitives_follow_the_reference_order(world4):
    xs = [W.ring_input(r).numpy() for r in range(4)]
    want = _ring_replay(xs, np.add)
    padded = [np.concatenate([x, np.zeros(3, np.float32)]) for x in xs]
    shards = _ring_replay(padded, np.add, start_offset=-1,
                          all_gather=False)
    for r, res in enumerate(world4):
        np.testing.assert_array_equal(res["ring/all_reduce"].numpy(),
                                      want[r])
        # the ring's sum order is not numpy's pairwise one: equal to it
        # within f32 rounding only
        np.testing.assert_allclose(res["ring/all_reduce"].numpy(),
                                   np.sum(xs, axis=0), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(res["ring/reduce_scatter"].numpy(),
                                      shards[r])
        assert res["ring/reduce_scatter"].shape == (1004 // 4,)
        np.testing.assert_array_equal(
            res["ring/all_gather"].numpy(),
            np.concatenate([x[:5] for x in xs]))
        # 2(P-1) hops, then P-1 and P-1
        assert res["ring/calls"]["ring_shift"] == 12
        assert _issued(res["ring/calls"]) == 12


@pytest.mark.parametrize("be", ["flat", "hierarchical", "ringsim"])
def test_broadcast_is_root_s_value_on_every_backend(world4, be):
    """Mask and sum: every worker ends with worker 2's buffer (its flat
    rank over the levels, pod-major, on the hierarchical backend)."""
    want = W.ring_input(2)
    for res in world4:
        assert torch.equal(res[f"broadcast/{be}"], want)


@pytest.mark.parametrize("name", sorted(F8))
def test_fp8_ring_adds_as_the_reference(world4, name):
    """fp8 buffers sum in flight hop by hop, each add the reference's
    float8 add (widen, add, round back: NaN past e4m3fn's range):
    against jnp on a pair (order-free) and on the world of 4 in the
    ring's order."""
    jdt = F8[name]
    wires = [np.asarray(jnp.asarray(W.ring_input(r, 200.0).numpy()
                                    ).astype(jdt)) for r in range(4)]

    def add(a, b):
        return np.asarray(jnp.asarray(a) + jnp.asarray(b))

    world = _ring_replay(wires, add)
    for r, res in enumerate(world4):
        pod = r // 2
        pair = add(wires[2 * pod], wires[2 * pod + 1])
        for got, want in ((res[f"ring/{name}/pair"], pair),
                          (res[f"ring/{name}/world"], world[r])):
            g, w = got.numpy(), want.view(np.uint8)
            gnan = np.isnan(g.view(jdt).astype(np.float32))
            np.testing.assert_array_equal(gnan, np.isnan(
                want.astype(np.float32)))
            np.testing.assert_array_equal(g[~gnan], w[~gnan])
        if name == "f8e4m3":
            assert np.isnan(res[f"ring/{name}/world"].numpy().view(
                jdt).astype(np.float32)).any()


# ---------------------------------------------------------------------------
# reduce-scatter + allgather, fp8 wires, overlap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["flat/rs_identity", "flat/rs_bf16",
                                  "ringsim/rs_identity",
                                  "ringsim/rs_bf16"])
def test_reduce_scatter_matches_fused_allreduce(world4, name):
    for res in world4:
        for k in range(2):
            base = np.concatenate([res[f"flat/identity/{k}/{leaf}"].numpy()
                                   .reshape(-1) for leaf in LEAVES])
            got = np.concatenate([res[f"{name}/{k}/{leaf}"].numpy()
                                  .reshape(-1) for leaf in LEAVES])
            assert got.dtype == np.float32
            if name.endswith("identity"):
                np.testing.assert_allclose(got, base, rtol=1e-6, atol=1e-6)
            else:                          # the reference's bf16 bound
                scale = max(np.abs(base).max(), 1.0)
                assert np.abs(got - base).max() < 0.02 * scale


@pytest.mark.parametrize("name,rel", [("flat/f8e4m3", 0.2),
                                      ("hierarchical/f8e5m2", 0.35)])
def test_fp8_wires_average_within_their_precision(world4, name, rel):
    """The fp8 wire averages through the ring's fp8 adds: finite here
    (|x| stays far inside the range) and within the wire's precision of
    the identity average (3 and 2 mantissa bits, a few roundings)."""
    for res in world4:
        for k in range(2):
            for leaf in LEAVES:
                base = res[f"flat/identity/{k}/{leaf}"].numpy()
                got = res[f"{name}/{k}/{leaf}"].numpy()
                assert np.isfinite(got).all()
                assert np.abs(got - base).max() <= rel * max(
                    np.abs(base).max(), 1.0)


@pytest.mark.parametrize("codec", ["identity", "int8+ef"])
@pytest.mark.parametrize("be", ["flat", "hierarchical", "ringsim"])
def test_overlap_is_bitwise_fused_on_every_backend(world4, be, codec):
    for res in world4:
        fused = res[f"step/{be}/{codec}/False/state"]
        for overlap in ("staged", "backward"):
            got = res[f"step/{be}/{codec}/{overlap}/state"]
            assert len(got) == len(fused)
            for a, b in zip(got, fused):
                assert torch.equal(a, b), (overlap, a.shape)
