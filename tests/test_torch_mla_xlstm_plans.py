"""deepseek-v2-236b and xlstm-125m at full width against the JAX package,
shapes only (``meta`` tensors in the port, ``jax.eval_shape`` in the
reference; nothing is allocated):

  * the parameter trees: leaves, shapes, dtypes and the counts,
    244,188,441,600 for deepseek-v2-236b (9,153,243,136 at depth 2, the
    depth the card serves) and 220,493,664 for xlstm-125m (every layer
    holds an mLSTM and an sLSTM block, as the reference's stacks);
  * the ExchangePlan of one worker's gradient-contribution tree as the
    launcher builds it (``meta_worker_grads``), at the batch each trains
    with on the card (deepseek-v2 8 x 256 tokens, its embedding's rows
    (2048, 5120) into (102400, 5120); xlstm 2 x 256, (512, 768) into the
    tied (50304, 768)), against the reference's abstract
    ``grad_contributions``, under dense_reduce and sparse_gather with
    the identity and int8+ef wires: leaf specs, buckets, schedule,
    collective counts and the wire, buffer and state bytes exactly
    equal;
  * ``meta_worker_grads``' tree, built without a forward or backward
    pass, equal to the one autograd gives on meta tensors
    (``grad_contributions``) for every config, reduced, at 2 x 16
    tokens.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.core import (ExchangeConfig as JExchangeConfig,   # noqa: E402
                        exchange as jexchange)
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.training.gradients import abstract_grad_contributions  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config            # noqa: E402
from repro_torch.core import ExchangeConfig, exchange           # noqa: E402
from repro_torch.core.indexed_slices import IndexedSlices       # noqa: E402
from repro_torch.data import make_pipeline                      # noqa: E402
from repro_torch.launch import train                            # noqa: E402
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.training.gradients import grad_contributions    # noqa: E402
from repro_torch.tree import tree_flatten                       # noqa: E402
from test_torch_exchange import _slot_tuple, _spec_tuple        # noqa: E402

jax.config.update("jax_platform_name", "cpu")

WIRES = {
    "dense_reduce": dict(sparse_as_dense=True),
    "sparse_gather": dict(),
    "dense_reduce_int8+ef": dict(sparse_as_dense=True, codec="int8",
                                 error_feedback=True),
    "sparse_gather_int8+ef": dict(codec="int8", error_feedback=True),
}
BATCH = {"deepseek-v2-236b": (8, 256), "xlstm-125m": (2, 256)}


@pytest.mark.parametrize("arch,n_layers,want", [
    ("deepseek-v2-236b", 60, 244_188_441_600),
    ("deepseek-v2-236b", 2, 9_153_243_136),
    ("xlstm-125m", 12, 220_493_664)])
def test_full_width_layout_matches_reference(arch, n_layers, want):
    cfg = get_config(arch).with_(n_layers=n_layers)
    jcfg = jget_config(arch).with_(n_layers=n_layers)
    params = build_model(cfg).init(device="meta")
    tl = tree_flatten(params)[0]
    jl = jax.tree_util.tree_leaves(
        jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0)))
    assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
    assert [str(t.dtype).removeprefix("torch.") for t in tl] == \
        [str(j.dtype) for j in jl]
    assert sum(t.numel() for t in tl) == want
    assert sum(int(j.size) for j in jl) == want
    if cfg.mla is not None:
        attn = params["layers"]["attn"]
        assert tuple(attn["wq"].shape) == (n_layers, 5120, 128 * 192)
        assert tuple(attn["w_uv"].shape) == (n_layers, 512, 128 * 128)
        assert tuple(params["layers"]["ffn"]["w_gate"].shape) == (
            n_layers, 160, 5120, 1536)
    else:
        assert tuple(params["mlstm"]["wq"].shape) == (12, 1536, 1536)
        assert tuple(params["slstm"]["r_zifo"].shape) == (12, 4, 192, 768)
        assert params["slstm"]["r_zifo"].dtype == torch.float32


@pytest.fixture(scope="module", params=sorted(BATCH))
def trees(request):
    """One worker's full-width gradient-contribution tree, shapes only,
    in both packages."""
    arch = request.param
    b, s = BATCH[arch]
    jmodel = jbuild_model(jget_config(arch))
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    sds = jax.ShapeDtypeStruct
    jbatch = {"tokens": sds((b, s), jnp.int32),
              "labels": sds((b, s), jnp.int32)}
    jg = abstract_grad_contributions(jmodel, jparams, jbatch,
                                     sparse_embedding=True)
    cfg = get_config(arch)
    args = train.parse_args(["--arch", arch, "--batch-per-worker", str(b),
                             "--seq-len", str(s)])
    tg = train.meta_worker_grads(args, build_model(cfg),
                                 make_pipeline(cfg, b, s), True)
    return arch, tg, jg


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_plan_matches_reference_at_full_width(trees, wire):
    arch, tg, jg = trees
    tplan = exchange.compile_plan(tg, ExchangeConfig(use_kernel=True,
                                                     **WIRES[wire]))
    jplan = jexchange.compile_plan(jg, JExchangeConfig(use_kernel=True,
                                                       **WIRES[wire]))
    assert [_spec_tuple(s) for s in tplan.leaf_specs] == \
        [_spec_tuple(s) for s in jplan.leaf_specs]
    assert tplan.dense_leaf_ids == jplan.dense_leaf_ids
    assert tplan.gather_leaf_ids == jplan.gather_leaf_ids
    assert len(tplan.dense_buckets) == len(jplan.dense_buckets)
    for tb, jb in zip(tplan.dense_buckets, jplan.dense_buckets):
        assert [_slot_tuple(s) for s in tb.slots] == \
            [_slot_tuple(s) for s in jb.slots]
        assert (tb.collective, tb.n_elems, tb.wire_dtype) == (
            jb.collective, jb.n_elems, jb.wire_dtype)
    assert [(s.kind, s.bucket_id, s.leaf_ids)
            for s in tplan.schedule.stages] == \
        [(s.kind, s.bucket_id, s.leaf_ids) for s in jplan.schedule.stages]
    assert tplan.n_collectives == jplan.n_collectives
    assert tplan.state_bytes() == jplan.state_bytes()
    for p in (1, 8, 64):
        assert tplan.wire_bytes(p) == jplan.wire_bytes(p), p
        assert tplan.buffer_bytes(p) == jplan.buffer_bytes(p), p
    rows = BATCH[arch][0] * BATCH[arch][1]
    emb = tg["embedding"][0]
    assert tuple(emb.values.shape) == (rows, get_config(arch).d_model)
    assert emb.dense_shape == (get_config(arch).vocab,
                               get_config(arch).d_model)


def _structure(tree):
    leaves, treedef = tree_flatten(tree)
    out = []
    for x in leaves:
        for c in (x if isinstance(x, list) else [x]):
            if isinstance(c, IndexedSlices):
                out.append(("slices", tuple(c.indices.shape), c.indices.dtype,
                            tuple(c.values.shape), c.values.dtype,
                            tuple(c.dense_shape)))
            else:
                out.append((tuple(c.shape), c.dtype, c.device.type))
    return treedef, out


@pytest.mark.parametrize("sparse_embedding", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_worker_grads_is_autograds_tree(arch, sparse_embedding):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    pipe = make_pipeline(cfg, 2, 16)
    args = train.parse_args(["--arch", arch, "--reduced",
                             "--batch-per-worker", "2", "--seq-len", "16"])
    got = train.meta_worker_grads(args, model, pipe, sparse_embedding)
    meta = torch.device("meta")
    batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype,
                            device=meta)
             for k, v in pipe.batch_at(0).items()}
    want, _, _ = grad_contributions(model, model.init(device=meta), batch,
                                    sparse_embedding=sparse_embedding)
    assert _structure(got) == _structure(want)
