"""The port's paged KV cache and ``Model.reset_slots`` against the JAX
package's, for the reduced llama3.2-1b, deepseek-v2-236b (ckv/kr),
zamba2-7b (attention segments paged, the Mamba2 state resident) and
xlstm-125m (nothing paged).

  * ``cache_leaf_paths`` names the same leaves, by the same key strings,
    and ``dense_cache_bytes`` and ``pool_bytes`` count the same bytes;
  * on the same numpy pool and the same block tables, ``gather_view``,
    ``writeback`` (rows, resident write-masks, ``length``) and the
    refill's reset are bitwise the reference's;
  * rows past ``n_valid`` stay untouched in the pool, free-on-finish
    recycles blocks, the pool sits below the dense cache;
  * ``Model.reset_slots`` is bitwise the reference's on the same cache,
    writes no tensor of its input, and leaves the other slots' decoding
    as it was.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.models import build_model as jbuild_model         # noqa: E402
from repro.serving import paged_cache as jpc                  # noqa: E402
from repro_torch import bridge                               # noqa: E402
from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.models import build_model                   # noqa: E402
from repro_torch.serving import (ContinuousBatcher,          # noqa: E402
                                 PagedKVCache, cache_leaf_paths,
                                 dense_cache_bytes)
from repro_torch.serving.paged_cache import (gather_view,   # noqa: E402
                                             writeback)
from repro_torch.tree import (tree_leaves_with_path,        # noqa: E402
                              tree_map_with_path)

jax.config.update("jax_platform_name", "cpu")

FAMILIES = ("llama3.2-1b", "deepseek-v2-236b", "zamba2-7b", "xlstm-125m")
#: (n_slots, block_size, n_blocks, max_blocks_per_slot)
POOL = (3, 4, 10, 4)


@pytest.fixture(scope="module", params=FAMILIES)
def models(request):
    arch = request.param
    return (jbuild_model(jget_config(arch).reduced()),
            build_model(get_config(arch).reduced()))


def _jpaths(tree):
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tpaths(tree):
    return {p: bridge.tensor_to_array(t)
            for p, t in tree_leaves_with_path(tree)}


def _same(ttree, jtree):
    got, want = _tpaths(ttree), _jpaths(jtree)
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def _fill(rng, tree, overrides=()):
    """Random numpy leaves of ``tree``'s shapes and dtypes, by path."""
    out = {}
    for path, t in tree_leaves_with_path(tree):
        a = bridge.tensor_to_array(t)
        if a.dtype.kind == "f":
            out[path] = rng.standard_normal(a.shape).astype(a.dtype)
        else:
            out[path] = np.asarray(dict(overrides).get(
                path, rng.integers(0, 4, a.shape)), a.dtype)
    return out


def _both(tmpl_t, tmpl_j, arrays):
    """The same arrays as the port's tree and the reference's."""
    t = tree_map_with_path(lambda p, x: torch.from_numpy(arrays[p].copy()),
                           tmpl_t)
    j = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(arrays[jax.tree_util.keystr(p)]), tmpl_j)
    return t, j


def test_classification_and_bytes_match_reference(models):
    jmodel, tmodel = models
    for n_slots in (1, 2, 5):
        assert cache_leaf_paths(tmodel, n_slots) == \
            jpc.cache_leaf_paths(jmodel, n_slots)
    assert not any(p.endswith("['length']")
                   for p in cache_leaf_paths(tmodel, 2))
    assert bool(cache_leaf_paths(tmodel, 2)) == \
        (tmodel.cfg.family != "ssm")
    for n_slots, cache_len in ((2, 16), (4, 64)):
        assert dense_cache_bytes(tmodel, n_slots, cache_len) == \
            jpc.dense_cache_bytes(jmodel, n_slots, cache_len)
    pc = PagedKVCache(tmodel, *POOL, "cpu")
    assert pc.pool_bytes() == jpc.PagedKVCache(jmodel, *POOL).pool_bytes()


def test_view_writeback_and_reset_bitwise_reference(models):
    """Three slots with 9, 3 and 14 tokens' blocks; a chunk of 4 written
    at each slot's length with n_valid (2, 0, 4); then slot 2 refilled."""
    jmodel, tmodel = models
    pc = PagedKVCache(tmodel, *POOL, "cpu")
    jc = jpc.PagedKVCache(jmodel, *POOL)
    for slot, n in ((0, 9), (1, 3), (2, 14)):
        assert pc.ensure(slot, n) and jc.ensure(slot, n)
    np.testing.assert_array_equal(pc.block_tables, jc.block_tables)
    rng = np.random.default_rng(0)
    pos0 = np.array([3, 0, 9], np.int32)
    pc.state, jc.state = _both(pc.state, jc.state, _fill(
        rng, pc.state, [("['length']", pos0)]))
    view = gather_view(pc.state, pc.tables(), pc._paged)
    jview = jpc.gather_view(jc.state, jc.tables(), jc._paged)
    _same(view, jview)
    chunk, n_valid = 4, np.array([2, 0, 4], np.int32)
    new_view, jnew_view = _both(view, jview, _fill(
        rng, view, [("['length']", pos0 + n_valid)]))
    state = writeback(pc.state, new_view, pc.block_tables, pos0, n_valid,
                      chunk, pc._paged, pc.block_size, pc.n_blocks)
    jstate = jpc.writeback(jc.state, jnew_view, jc.tables(),
                           jnp.asarray(pos0), jnp.asarray(n_valid), chunk,
                           jc._paged, jc.block_size, jc.n_blocks)
    _same(state, jstate)
    assert state["length"].tolist() == [5, 0, 13]
    pc.state, jc.state = state, jstate
    pc.reset_slot(2)
    jc.reset_slot(2)
    _same(pc.state, jc.state)
    assert pc.state["length"].tolist() == [5, 0, 0]


def test_writeback_leaves_rows_past_n_valid_untouched():
    """Rows written through the view land in the right pool block and
    gather back; rows past n_valid and on sentinel blocks are left out."""
    m = build_model(get_config("llama3.2-1b").reduced())
    pc = PagedKVCache(m, n_slots=2, block_size=4, n_blocks=8,
                      max_blocks_per_slot=3, device="cpu")
    assert pc.ensure(0, 6) and pc.ensure(1, 2)
    v = gather_view(pc.state, pc.tables(), pc._paged)
    chunk = 3
    filled = v["k"].clone()
    filled[:, :, :chunk] = torch.arange(
        filled[:, :, :chunk].numel(), dtype=filled.dtype).reshape(
        filled[:, :, :chunk].shape)
    new_state = writeback(pc.state, {**v, "k": filled}, pc.block_tables,
                          np.zeros(2, np.int32), np.array([3, 1], np.int32),
                          chunk, pc._paged, pc.block_size, pc.n_blocks)
    back = gather_view(new_state, pc.tables(), pc._paged)
    assert torch.equal(back["k"][:, 0, :3], filled[:, 0, :3])
    assert torch.equal(back["k"][:, 1, :1], filled[:, 1, :1])
    assert not bool(back["k"][:, 1, 1:3].any())
    assert new_state["length"].tolist() == [3, 1]
    # slot 1 owns one block: rows 4.. of its table are the sentinel, and a
    # row there (n_valid past its blocks) is dropped, not written anywhere
    pool = new_state["k"].clone()
    late = writeback(new_state, {**v, "k": filled}, pc.block_tables,
                     np.array([0, 4], np.int32), np.array([0, 2], np.int32),
                     2, pc._paged, pc.block_size, pc.n_blocks)
    assert torch.equal(late["k"], pool)


def test_free_on_finish_and_refill():
    m = build_model(get_config("llama3.2-1b").reduced())
    pc = PagedKVCache(m, n_slots=2, block_size=4, n_blocks=4,
                      max_blocks_per_slot=2, device="cpu")
    assert pc.ensure(0, 8) and pc.ensure(1, 8)
    assert pc.n_free_blocks == 0
    with pytest.raises(ValueError, match="max_blocks_per_slot"):
        pc.ensure(0, 9)
    pc.release(0)
    assert pc.n_free_blocks == 2
    assert np.all(pc.block_tables[0] == pc.n_blocks)   # sentinel restored
    assert pc.ensure(0, 5)                             # recycled blocks
    assert pc.n_free_blocks == 0
    # a dry pool allocates nothing and says so (the preemption trigger)
    dry = PagedKVCache(m, n_slots=2, block_size=4, n_blocks=3,
                       max_blocks_per_slot=2, device="cpu")
    assert dry.ensure(0, 8)
    assert not dry.ensure(1, 8)
    assert dry.slot_blocks[1] == [] and dry.n_free_blocks == 1
    with pytest.raises(ValueError, match="one block each"):
        PagedKVCache(m, n_slots=2, block_size=4, n_blocks=1,
                     max_blocks_per_slot=2, device="cpu")


def test_pool_below_dense():
    m = build_model(get_config("llama3.2-1b").reduced())
    cb = ContinuousBatcher(m, m.init(seed=0, device="cpu"), n_slots=4,
                           cache_len=64, block_size=8, n_blocks=16)
    assert cb.paged.pool_bytes() < dense_cache_bytes(m, 4, 64)
    assert cb.paged.state["k"].device.type == "cpu"


def test_reset_slots_bitwise_reference(models):
    jmodel, tmodel = models
    rng = np.random.default_rng(1)
    tmpl = tmodel.init_cache(3, 8, device="cpu")
    cache, jcache = _both(tmpl, jmodel.init_cache(3, 8), _fill(
        rng, tmpl, [("['length']", [5, 2, 7])]))
    before = {p: t.clone() for p, t in tree_leaves_with_path(cache)}
    mask = np.array([True, False, True])
    got = tmodel.reset_slots(cache, torch.as_tensor(mask))
    _same(got, jmodel.reset_slots(jcache, jnp.asarray(mask)))
    assert got["length"].tolist() == [0, 2, 0]
    for p, t in tree_leaves_with_path(cache):
        assert torch.equal(t, before[p]), p


def test_reset_slots_isolates():
    """Resetting slot 0 leaves slot 1's next step as it was."""
    m = build_model(get_config("llama3.2-1b").reduced())
    params = m.init(seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, m.cfg.vocab, (2, 4)).astype(np.int32))
    cache = m.init_cache(2, 16, device="cpu")
    for i in range(4):
        _, cache = m.decode_step(params, cache, toks[:, i:i + 1])
    cache2 = m.reset_slots(cache, np.array([True, False]))
    assert cache2["length"].tolist() == [0, 4]
    l_ref, _ = m.decode_step(params, cache, toks[:, 3:4])
    l_new, _ = m.decode_step(params, cache2, toks[:, 3:4])
    np.testing.assert_allclose(l_new[1].numpy(), l_ref[1].numpy(),
                               rtol=1e-5, atol=1e-5)
