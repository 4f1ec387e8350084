"""Horovod's sparse allgather and fused allreduce of the port over a gloo
world of 2 (``tests/_torch_dist_worker.py::run_library``, spawned once):

  * ``comm.all_gather_slices`` gives P * n rows in rank order, over the
    world and over a two-level tuple of it (one level at a time,
    innermost first: P * P * n rows), for f32 and bf16 values; its wire
    recorder holds one ``all-gather`` a level of the reference's bytes,
    ``(p - 1) * (index bytes + value bytes)`` of that level's input
    (``src/repro/core/comm.py:144-148``), and ``all_gather_dense`` ran
    twice a level;
  * ``fusion.fused_all_reduce`` equals the tree-wise mean (and sum) of
    the two ranks' trees within f32 rounding, with one allreduce per
    fusion bucket (``collective_launches``, the reference's count).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.core import fusion as jfusion                       # noqa: E402
from repro_torch.core import fusion                            # noqa: E402
from repro_torch.tree import tree_flatten                      # noqa: E402

import _torch_dist_worker as W                                 # noqa: E402
from _torch_world import spawn_world                           # noqa: E402

WORLD = 2


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("library_world")
    spawn_world(W.run_library, WORLD, out, timeout=240)
    return [torch.load(out / f"rank{r}.pt") for r in range(WORLD)]


def _reference_wire(rows: int, row_elems: int, value_bytes: int,
                    levels) -> list:
    """The reference's per-level billing of ``all_gather_slices``: each
    level bills (p - 1) * (index + value bytes) of its input, whose rows
    have grown by the inner levels' sizes."""
    out = []
    for p in reversed(levels):
        out.append((p - 1) * rows * (4 + row_elems * value_bytes))
        rows *= p
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,levels", [("flat", (WORLD,)),
                                         ("two_level", (WORLD, WORLD))])
def test_all_gather_slices_rows_and_wire(results, name, levels, dtype):
    parts = [W.library_slices(r, dtype) for r in range(WORLD)]
    want_idx = torch.cat([s.indices for s in parts])
    want_val = torch.cat([s.values for s in parts])
    for _ in levels[1:]:          # each outer level repeats the whole
        want_idx = torch.cat([want_idx] * WORLD)
        want_val = torch.cat([want_val] * WORLD)
    rows = W.LIB_ROWS * WORLD ** len(levels)
    wire = _reference_wire(W.LIB_ROWS, W.LIB_D, dtype.itemsize, levels)
    for r in range(WORLD):
        got = results[r][f"{name}/{dtype}"]
        assert got["indices"].shape == (rows,)
        assert got["values"].shape == (rows, W.LIB_D)
        assert got["values"].dtype == dtype
        assert got["indices"].dtype == torch.int32
        assert got["dense_shape"] == (W.LIB_VOCAB, W.LIB_D)
        assert torch.equal(got["indices"], want_idx)
        assert torch.equal(got["values"], want_val)
        stage = got["wire"]["per_stage"]["gather"]
        assert stage["by_kind"] == {"all-gather": len(levels)}
        assert stage["collectives"] == len(levels)
        assert stage["wire_bytes"] == sum(wire)
        assert got["calls"]["all_gather_dense"] == 2 * len(levels)
        assert sum(got["calls"].values()) == 2 * len(levels)


@pytest.mark.parametrize("threshold", W.LIB_THRESHOLDS)
def test_fused_all_reduce_is_the_tree_mean(results, threshold):
    trees = [tree_flatten(W.library_tree(r))[0] for r in range(WORLD)]
    total = [sum(ls) for ls in zip(*trees)]
    buckets = fusion.collective_launches(W.library_tree(0), threshold)
    assert buckets == jfusion.collective_launches(
        {k: (jnp.asarray(v.numpy()) if not isinstance(v, dict) else
             {kk: jnp.asarray(vv.numpy()) for kk, vv in v.items()})
         for k, v in W.library_tree(0).items()}, threshold)
    assert (buckets > 1) == (threshold == W.LIB_THRESHOLDS[0])
    for r in range(WORLD):
        got = results[r][f"fused/{threshold}"]
        means, sums = tree_flatten(got["mean"])[0], tree_flatten(
            got["sum"])[0]
        assert len(means) == len(total)
        for m, s, t in zip(means, sums, total):
            # two addends: the sum is exact in any order
            assert torch.equal(s, t)
            np.testing.assert_allclose(m.numpy(), (t / WORLD).numpy(),
                                       rtol=1e-7, atol=0)
        # mean and sum: one allreduce per fusion bucket each
        assert got["calls"]["all_reduce_dense"] == 2 * buckets
