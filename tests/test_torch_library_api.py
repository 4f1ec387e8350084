"""The rest of the library API against the JAX package, on the same numpy
inputs:

  * ``ExchangePlan.accumulate_tree`` (and ``DistributedOptimizer.
    accumulate``) under Alg. 1, Alg. 2 and ``sparse_as_dense`` on a tied
    ``[IndexedSlices, dense]`` tree with an all-sparse leaf beside it:
    gather leaves' indices and values exactly, dense leaves within 1e-6;
  * ``sparse_bytes_per_worker`` and ``fingerprint`` of every family's
    reduced gather plan, exactly, on trees from
    ``abstract_grad_contributions`` (structure, shapes and dtypes equal
    to the reference's ``eval_shape`` tree; transformer-big also at full
    width with the sparse embedding on and off);
  * the deprecated ``DistributedOptimizer`` flags: the same warnings,
    configs and ``TypeError``s, and the read-throughs;
  * ``fusion.collective_launches`` equal, ``fused_all_reduce`` at
    ``group=None`` bitwise its input;
  * ``IndexedSlices.from_dense``, ``dtype`` and ``is_indexed_slices``;
  * ``cosine_schedule`` and ``constant_schedule`` at steps 0-200 (f32,
    rtol 1e-6);
  * ``all_configs``, ``ArchConfig.sub_quadratic`` and ``INPUT_SHAPES``;
  * ``launch.train.meta_worker_grads`` builds its tree through
    ``abstract_grad_contributions``.
"""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro import configs as jconfigs                          # noqa: E402
from repro.core import (DistributedOptimizer as JDistOpt,    # noqa: E402
                        ExchangeConfig as JExchangeConfig,
                        exchange as jexchange, fusion as jfusion)
from repro.core.indexed_slices import (                        # noqa: E402
    IndexedSlices as JSlices, is_indexed_slices as j_is_slices)
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.optim import (adamw as jadamw,                      # noqa: E402
                         constant_schedule as jconstant,
                         cosine_schedule as jcosine)
from repro.training.gradients import (                          # noqa: E402
    abstract_grad_contributions as j_abstract)
from repro_torch import configs                                 # noqa: E402
from repro_torch.core import (DistributedOptimizer, ExchangeConfig,  # noqa: E402
                              clear_plan_cache, exchange, fusion,
                              is_indexed_slices)
from repro_torch.core.comm import dtype_name                    # noqa: E402
from repro_torch.core.indexed_slices import IndexedSlices       # noqa: E402
from repro_torch.launch import train                            # noqa: E402
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.optim import (adamw, constant_schedule,        # noqa: E402
                               cosine_schedule)
from repro_torch.training.gradients import \
    abstract_grad_contributions                                 # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves_with_path  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ACCUMULATIONS = {
    "alg1": dict(),
    "alg2": dict(algorithm="proposed_algorithm2"),
    "sparse_as_dense": dict(sparse_as_dense=True),
}


def tied_tree(seed: int = 0, v: int = 24, d: int = 8):
    """numpy leaves: a tied embedding ``[slices, dense]``, an all-sparse
    leaf ``[slices, slices]`` (duplicates included) and a dense one."""
    rng = np.random.default_rng(seed)

    def slices(n):
        return (rng.integers(0, v, n).astype(np.int32),
                rng.standard_normal((n, d)).astype(np.float32))
    return {"emb": [slices(6), rng.standard_normal((v, d)).astype(
                np.float32)],
            "tok": [slices(5), slices(4)],
            "w": rng.standard_normal((5, 3)).astype(np.float32)}, (v, d)


def _build(tree, shape, make_slices, make_dense):
    def conv(x):
        if isinstance(x, tuple):
            return make_slices(x[0], x[1], shape)
        if isinstance(x, list):
            return [conv(c) for c in x]
        return make_dense(x)
    return {k: conv(x) for k, x in tree.items()}


def both_trees(seed: int = 0):
    tree, shape = tied_tree(seed)
    t = _build(tree, shape, lambda i, x, s: IndexedSlices(
        torch.from_numpy(i), torch.from_numpy(x), s), torch.from_numpy)
    j = _build(tree, shape, lambda i, x, s: JSlices(
        jnp.asarray(i), jnp.asarray(x), s), jnp.asarray)
    return t, j


def _assert_leaf(got, want, exact_gather: bool):
    if isinstance(want, JSlices):
        assert isinstance(got, IndexedSlices)
        assert got.dense_shape == tuple(want.dense_shape)
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(want.indices))
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(want.values))
    else:
        assert isinstance(got, torch.Tensor)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("acc", sorted(ACCUMULATIONS))
def test_accumulate_tree_matches_reference(acc, use_kernel):
    """The port's densify route (kernel wrapper on the CPU: its plain
    version) against the reference's XLA scatter-add."""
    tg, jg = both_trees()
    kw = ACCUMULATIONS[acc]
    plan = exchange.compile_plan(tg, ExchangeConfig(use_kernel=use_kernel,
                                                    **kw))
    jplan = jexchange.compile_plan(jg, JExchangeConfig(**kw))
    got, want = plan.accumulate_tree(tg), jplan.accumulate_tree(jg)
    assert sorted(got) == sorted(want)
    for k in want:
        _assert_leaf(got[k], want[k], True)
    # the classification: Alg. 1 gathers the tied leaf, Alg. 2 and the
    # pre-pass reduce it; only the pre-pass densifies the all-sparse leaf
    assert isinstance(got["emb"], IndexedSlices) == (acc == "alg1")
    assert isinstance(got["tok"], IndexedSlices) == (
        acc != "sparse_as_dense")
    assert isinstance(got["w"], torch.Tensor)
    pending = plan.accumulate(tg)
    assert len(pending) == plan.n_leaves
    # DistributedOptimizer.accumulate is plan(grads).accumulate_tree
    for k, x in DistributedOptimizer(adamw(1e-3), ExchangeConfig(
            use_kernel=use_kernel, **kw)).accumulate(tg).items():
        _assert_leaf(x, JDistOpt(jadamw(1e-3), JExchangeConfig(
            **kw)).accumulate(jg)[k], True)


def test_accumulate_tree_rejects_another_structure():
    tg, _ = both_trees()
    plan = exchange.compile_plan(tg, ExchangeConfig())
    with pytest.raises(ValueError, match="structure"):
        plan.accumulate_tree({"w": tg["w"]})


# ---------------------------------------------------------------------------
# abstract_grad_contributions, sparse_bytes_per_worker, fingerprint
# ---------------------------------------------------------------------------

#: one config of every family (the paper's transformer-big is audio)
FAMILY_ARCHS = ("transformer-big", "llama3.2-1b", "zamba2-7b",
                "llama4-scout-17b-a16e", "deepseek-v2-236b", "xlstm-125m",
                "internvl2-1b")


def _batches(cfg, b, s):
    sds = jax.ShapeDtypeStruct
    jbatch = {"tokens": sds((b, s), jnp.int32),
              "labels": sds((b, s), jnp.int32)}
    tbatch = {"tokens": torch.zeros(b, s, dtype=torch.int32),
              "labels": torch.zeros(b, s, dtype=torch.int32)}
    if cfg.frontend is not None:
        shape = (b, cfg.frontend.n_embeds, cfg.d_model)
        jbatch["frontend"] = sds(shape, jnp.float32)
        tbatch["frontend"] = torch.empty(shape, device="meta")
    return jbatch, tbatch


def abstract_trees(arch, reduced: bool, sparse: bool, b=2, s=16):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jbatch, tbatch = _batches(cfg, b, s)
    jg = j_abstract(jmodel, jparams, jbatch, sparse_embedding=sparse)
    model = build_model(cfg)
    params = model.init(device="meta")
    tg = abstract_grad_contributions(model, params, tbatch,
                                     sparse_embedding=sparse)
    return tg, jg


def _describe(x):
    if isinstance(x, (IndexedSlices, JSlices)):
        return ("slices", _describe(x.indices), _describe(x.values),
                tuple(x.dense_shape))
    if isinstance(x, list):
        return [_describe(c) for c in x]
    dt = dtype_name(x.dtype) if isinstance(x, torch.Tensor) \
        else np.dtype(x.dtype).name
    return (tuple(x.shape), dt)


def _assert_same_tree(tg, jg):
    ours = [(p, _describe(x)) for p, x in tree_leaves_with_path(tg)]
    paths, _ = jax.tree_util.tree_flatten_with_path(
        jg, is_leaf=jexchange._is_leaf)
    theirs = [(jax.tree_util.keystr(p), _describe(x)) for p, x in paths]
    assert ours == theirs
    assert all(t.device.type == "meta" for t in _tensors(tg))


def _tensors(tree):
    out = []
    for leaf in tree_flatten(tree)[0]:
        for c in (leaf if isinstance(leaf, list) else [leaf]):
            out += ([c.indices, c.values] if isinstance(c, IndexedSlices)
                    else [c])
    return out


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_reduced_gather_plan_bytes_and_fingerprint_match(arch):
    """Every family's reduced tree (sparse embedding on), its gather
    plan's S term and fingerprint, exactly."""
    tg, jg = abstract_trees(arch, reduced=True, sparse=True)
    _assert_same_tree(tg, jg)
    for kw in (dict(), dict(codec="int8")):
        plan = exchange.compile_plan(tg, ExchangeConfig(**kw))
        jplan = jexchange.compile_plan(jg, JExchangeConfig(**kw))
        assert plan.gather_leaf_ids == jplan.gather_leaf_ids
        assert plan.gather_leaf_ids                 # the embedding gathers
        assert plan.sparse_bytes_per_worker == \
            jplan.sparse_bytes_per_worker > 0
        assert plan.fingerprint == jplan.fingerprint
    dense = exchange.compile_plan(tg, ExchangeConfig(sparse_as_dense=True))
    assert dense.sparse_bytes_per_worker == 0 == jexchange.compile_plan(
        jg, JExchangeConfig(sparse_as_dense=True)).sparse_bytes_per_worker


@pytest.mark.parametrize("sparse", [True, False])
def test_full_width_transformer_big_abstract_tree_matches(sparse):
    """Full-width transformer-big at 8 x 256 (nothing allocated): the
    same tree, fingerprint and gather bytes as the reference's."""
    tg, jg = abstract_trees("transformer-big", reduced=False,
                            sparse=sparse, b=8, s=256)
    _assert_same_tree(tg, jg)
    assert exchange.fingerprint(tg) == jexchange.fingerprint(jg)
    plan = exchange.compile_plan(tg, ExchangeConfig())
    jplan = jexchange.compile_plan(jg, JExchangeConfig())
    assert plan.fingerprint == jplan.fingerprint
    assert plan.sparse_bytes_per_worker == jplan.sparse_bytes_per_worker
    cfg = configs.get_config("transformer-big")
    # the S term: Alg. 1 gathers the tied table, its 8 x 256 lookup rows
    # and its dense projection gradient as vocab rows, each d_model bf16
    # values and an int32 id
    want = ((8 * 256 + cfg.vocab) * (cfg.d_model * 2 + 4) if sparse
            else 0)
    assert plan.sparse_bytes_per_worker == want


def test_abstract_tree_reads_only_shapes():
    """Concrete CPU parameters and batch give the same meta tree as meta
    ones: no forward, no backward."""
    cfg = configs.get_config("transformer-big").reduced()
    model = build_model(cfg)
    batch = {"tokens": torch.zeros(2, 16, dtype=torch.int32),
             "labels": torch.zeros(2, 16, dtype=torch.int32),
             "frontend": torch.zeros(2, cfg.frontend.n_embeds,
                                     cfg.d_model)}
    concrete = abstract_grad_contributions(
        model, model.init(seed=0, device="cpu"), batch,
        sparse_embedding=True, loss_chunk=8)
    meta = abstract_grad_contributions(
        model, model.init(device="meta"),
        {k: v.to("meta") for k, v in batch.items()}, sparse_embedding=True)
    assert _describe_tree(concrete) == _describe_tree(meta)
    assert all(t.device.type == "meta" for t in _tensors(concrete))


def _describe_tree(tree):
    return [(p, _describe(x)) for p, x in tree_leaves_with_path(tree)]


def test_meta_worker_grads_goes_through_abstract_grad_contributions(
        monkeypatch):
    args = train.parse_args(["--reduced", "--batch-per-worker", "2",
                             "--seq-len", "16", "--device", "cpu"])
    cfg = configs.get_config("transformer-big").reduced()
    model = build_model(cfg)
    from repro_torch.data import make_pipeline
    pipe = make_pipeline(cfg, 2, 16)
    calls = []

    def spy(*a, **kw):
        calls.append(kw)
        return abstract_grad_contributions(*a, **kw)
    monkeypatch.setattr(train, "abstract_grad_contributions", spy)
    tree = train.meta_worker_grads(args, model, pipe, True)
    assert calls == [{"sparse_embedding": True}]
    batch = {k: torch.from_numpy(v[:2]) for k, v in
             pipe.batch_at(0).items()}
    assert _describe_tree(tree) == _describe_tree(
        abstract_grad_contributions(model, model.init(device="meta"), batch,
                                    sparse_embedding=True))


# ---------------------------------------------------------------------------
# DistributedOptimizer: deprecated flags and read-throughs
# ---------------------------------------------------------------------------

def test_deprecated_optimizer_flags_map_onto_exchange_config():
    """The counterpart of the reference's test of the same name."""
    clear_plan_cache()
    tree, _ = both_trees()
    with pytest.warns(DeprecationWarning) as rec:
        old = DistributedOptimizer(adamw(1e-3), sparse_as_dense=True,
                                   reduce_scatter=True, wire_dtype="bf16",
                                   use_kernel=False,
                                   fusion_threshold=1 << 20)
    with pytest.warns(DeprecationWarning) as jrec:
        JDistOpt(jadamw(1e-3), sparse_as_dense=True, reduce_scatter=True,
                 wire_dtype="bf16", use_kernel=False,
                 fusion_threshold=1 << 20)
    assert [str(w.message) for w in rec] == [str(w.message) for w in jrec]
    new = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
        sparse_as_dense=True, reduce_scatter=True, codec="bf16",
        fusion_threshold=1 << 20))
    assert old.exchange_config == new.exchange_config
    assert old.plan(tree) is new.plan(tree)        # identical cached plan
    with pytest.warns(DeprecationWarning):
        hier = DistributedOptimizer(adamw(1e-3), hierarchical=True)
    assert hier.exchange_config.backend == "hierarchical"
    with pytest.warns(DeprecationWarning):
        levels = DistributedOptimizer(adamw(1e-3), hierarchical=True,
                                      hierarchy_levels=3,
                                      algorithm="proposed_algorithm2")
    assert levels.exchange_config == ExchangeConfig(
        backend="hierarchical", hierarchy_levels=3,
        algorithm="proposed_algorithm2")
    # mixing both styles is an error, as is an unknown keyword: the
    # reference's messages
    for ours, theirs in (
            (lambda: DistributedOptimizer(adamw(1e-3),
                                          exchange=ExchangeConfig(),
                                          sparse_as_dense=True),
             lambda: JDistOpt(jadamw(1e-3), exchange=JExchangeConfig(),
                              sparse_as_dense=True)),
            (lambda: DistributedOptimizer(adamw(1e-3), ExchangeConfig(),
                                          use_kernel=True),
             lambda: JDistOpt(jadamw(1e-3), JExchangeConfig(),
                              use_kernel=True)),
            (lambda: DistributedOptimizer(adamw(1e-3),
                                          sparse_az_dense=True),
             lambda: JDistOpt(jadamw(1e-3), sparse_az_dense=True))):
        with pytest.raises(TypeError) as got:
            ours()
        with pytest.raises(TypeError) as want:
            theirs()
        assert str(got.value) == str(want.value)
    # no warning for pure new-style construction; a flag left at None is
    # no flag
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig())
        DistributedOptimizer(adamw(1e-3))
        DistributedOptimizer(adamw(1e-3), ExchangeConfig(),
                             sparse_as_dense=None)


@pytest.mark.parametrize("kw", [dict(), dict(sparse_as_dense=True),
                                dict(algorithm="proposed_algorithm2",
                                     codec="int8+ef")])
def test_optimizer_read_throughs_match_reference(kw):
    opt = DistributedOptimizer(adamw(1e-3), ExchangeConfig(**kw))
    jopt = JDistOpt(jadamw(1e-3), JExchangeConfig(**kw))
    assert (opt.stateful, opt.sparse_as_dense, opt.algorithm) == (
        jopt.stateful, jopt.sparse_as_dense, jopt.algorithm)
    # exchange= overrides the positional config
    over = DistributedOptimizer(adamw(1e-3), ExchangeConfig(**kw),
                                exchange=ExchangeConfig(codec="bf16"))
    assert over.exchange_config == ExchangeConfig(codec="bf16")
    assert over.group is None


# ---------------------------------------------------------------------------
# fusion, IndexedSlices, schedules, configs
# ---------------------------------------------------------------------------

def _fusion_trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (64, 32), "b": (7,), "c": {"d": (128, 16), "e": (3, 5)},
              "f": (300,)}

    def mk(s, conv):
        if isinstance(s, dict):
            return {k: mk(v, conv) for k, v in s.items()}
        return conv(rng.standard_normal(s).astype(np.float32))
    t = mk(shapes, torch.from_numpy)
    rng = np.random.default_rng(seed)
    j = mk(shapes, jnp.asarray)
    return t, j


@pytest.mark.parametrize("threshold", [1, 4096, 1 << 20])
def test_collective_launches_and_local_fused_all_reduce(threshold):
    t, j = _fusion_trees()
    assert fusion.collective_launches(t, threshold) == \
        jfusion.collective_launches(j, threshold)
    for average in (True, False):
        out = fusion.fused_all_reduce(t, None, threshold_bytes=threshold,
                                      average=average)
        got, want = tree_flatten(out)[0], tree_flatten(t)[0]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_indexed_slices_from_dense_dtype_and_predicate():
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((10, 4)).astype(np.float32)
    idx = np.array([3, 0, 3, 9], dtype=np.int32)
    s = IndexedSlices.from_dense(torch.from_numpy(dense),
                                 torch.from_numpy(idx))
    js = JSlices.from_dense(jnp.asarray(dense), jnp.asarray(idx))
    assert s.dense_shape == tuple(js.dense_shape) == (10, 4)
    np.testing.assert_array_equal(s.indices.numpy(), np.asarray(js.indices))
    np.testing.assert_array_equal(s.values.numpy(), np.asarray(js.values))
    assert s.dtype == torch.float32 and js.dtype == jnp.float32
    bf = IndexedSlices.from_dense(torch.from_numpy(dense).bfloat16(),
                                  torch.from_numpy(idx))
    assert bf.dtype == torch.bfloat16
    for x in (s, [s], s.values, None):
        jx = js if x is s else x
        assert is_indexed_slices(x) == j_is_slices(jx)
    assert is_indexed_slices(s) and not is_indexed_slices(s.values)


@pytest.mark.parametrize("args", [(1e-3, 10, 100), (3e-4, 0, 150),
                                  (2e-3, 50, 50, 0.0), (1e-2, 7, 180, 0.3)])
def test_cosine_schedule_matches_reference(args):
    ours, theirs = cosine_schedule(*args), jcosine(*args)
    steps = np.arange(0, 201)
    got = np.array([float(ours(torch.tensor(int(t), dtype=torch.int32)))
                    for t in steps], dtype=np.float32)
    want = np.array([float(theirs(int(t))) for t in steps],
                    dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert ours(torch.tensor(5)).dtype == torch.float32
    assert float(ours(5)) == float(ours(torch.tensor(5)))


def test_constant_schedule_matches_reference():
    ours, theirs = constant_schedule(3e-4), jconstant(3e-4)
    for t in range(0, 201, 20):
        got = ours(torch.tensor(t, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == float(theirs(t))
    # the optimizer takes it as its rate
    opt = adamw(constant_schedule(1e-2))
    p = {"w": torch.ones(3)}
    upd, _ = opt.update({"w": torch.ones(3)}, opt.init(p), p)
    assert torch.all(upd["w"] < 0)


def test_configs_registry_and_input_shapes_match_reference():
    ours, theirs = configs.all_configs(), jconfigs.all_configs()
    assert list(ours) == list(theirs) == list(configs.ARCH_IDS)
    for arch in ours:
        assert ours[arch].sub_quadratic == theirs[arch].sub_quadratic, arch
        assert ours[arch].reduced().sub_quadratic == \
            theirs[arch].reduced().sub_quadratic
        windowed = ours[arch].with_(sliding_window=4096)
        assert windowed.sub_quadratic
    assert ours["zamba2-7b"].sub_quadratic and ours["xlstm-125m"].sub_quadratic
    assert {k: dataclasses.asdict(v)
            for k, v in configs.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}
    assert configs.INPUT_SHAPES["prefill_32k"] == configs.InputShape(
        "prefill_32k", 32_768, 32, "prefill")
