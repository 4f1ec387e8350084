"""The port's stage names, schedule tables and ``ExchangeStats`` against
the reference's, and the telemetry hooks' unit cases:

  * ``stage_names()``, ``describe_schedule(n)`` and ``describe()`` equal
    the reference's for the same gradient tree under identity, int8,
    int8+ef, reduce-scatter, ringsim, hierarchical (2, 2), staged,
    wait-free (names carry ``/trigger=``), zero1 and sparse_gather
    (``bucket=leafK``); ``describe`` differs only in the backend's name
    (the port's ``flat`` is the reference's ``jax``);
  * ``exchange_stats(...)`` equal field by field, strategy included, at
    n_workers 1, 8 and (2, 4) (hierarchical: (2, 2) and (2, 4)) for the
    ``ib`` and ``ethernet`` profiles;
  * ``hooks.tap`` is the identity with nothing installed, stage scopes
    nest, a second install raises.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.core import DistributedOptimizer as JDistOpt        # noqa: E402
from repro.core import exchange as jexchange                   # noqa: E402
from repro.core.indexed_slices import IndexedSlices as JSlices  # noqa: E402
from repro.optim import adamw as jadamw                        # noqa: E402
from repro_torch import bridge                                 # noqa: E402
from repro_torch.core import DistributedOptimizer, exchange    # noqa: E402
from repro_torch.core.indexed_slices import IndexedSlices      # noqa: E402
from repro_torch.optim import adamw                            # noqa: E402
from repro_torch.telemetry import hooks                        # noqa: E402

jax.config.update("jax_platform_name", "cpu")

VOCAB, D = 64, 8

#: name -> ExchangeConfig keywords (the port's backend names)
CONFIGS = {
    "identity": dict(sparse_as_dense=True),
    "int8": dict(sparse_as_dense=True, codec="int8"),
    "int8+ef": dict(sparse_as_dense=True, codec="int8",
                    error_feedback=True),
    "reduce_scatter": dict(sparse_as_dense=True, reduce_scatter=True),
    "ringsim": dict(sparse_as_dense=True, backend="ringsim"),
    "hierarchical": dict(sparse_as_dense=True, backend="hierarchical"),
    "hierarchical_int8": dict(sparse_as_dense=True, backend="hierarchical",
                              codec="int8"),
    "staged": dict(sparse_as_dense=True, codec="int8", overlap="staged"),
    "wait_free": dict(sparse_as_dense=True, overlap="backward"),
    "zero1": dict(sparse_as_dense=True, zero1=True),
    "zero1_param_int8": dict(sparse_as_dense=True, zero1=True,
                             param_codec="int8"),
    "sparse_gather": dict(),
    "sparse_gather_int8_ringsim": dict(codec="int8", backend="ringsim"),
}
BACKENDS = {"flat": "jax", "hierarchical": "hierarchical",
            "ringsim": "ringsim"}


def ref_kw(kw):
    """The reference's keywords of a port config (backend mapped)."""
    if "backend" not in kw:
        return kw
    return dict(kw, backend=BACKENDS[kw["backend"]])


def is_hier(name):
    return CONFIGS[name].get("backend") == "hierarchical"


def worker_levels(name):
    return [(2, 2), (2, 4)] if is_hier(name) else [1, 8, (2, 4)]


def _arrays():
    """One worker's contributions from a seed: a tied embedding (sparse
    rows and a dense part) and three dense blocks."""
    rng = np.random.default_rng(7)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"idx": rng.integers(0, VOCAB, 12).astype(np.int32),
            "rows": f(12, D), "emb": f(VOCAB, D), "w": f(3, D, 5),
            "b": f(5,), "head": f(40, 40), "norm": f(D,)}


def port_grads():
    a = {k: bridge.array_to_tensor(v, "cpu") for k, v in _arrays().items()}
    return {"embedding": [IndexedSlices(a["idx"], a["rows"], (VOCAB, D)),
                          a["emb"]],
            "layers": {"w": a["w"], "b": a["b"]},
            "head": a["head"], "final_norm": a["norm"]}


def ref_grads():
    a = {k: jnp.asarray(v) for k, v in _arrays().items()}
    return {"embedding": [JSlices(a["idx"], a["rows"], (VOCAB, D)),
                          a["emb"]],
            "layers": {"w": a["w"], "b": a["b"]},
            "head": a["head"], "final_norm": a["norm"]}


def plans(name):
    kw = CONFIGS[name]
    return (exchange.compile_plan(port_grads(),
                                  exchange.ExchangeConfig(**kw)),
            jexchange.compile_plan(ref_grads(),
                                   jexchange.ExchangeConfig(**ref_kw(kw))))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stage_names_equal_reference(name):
    plan, jplan = plans(name)
    names = plan.stage_names()
    assert names == jplan.stage_names()
    assert len(names) == plan.schedule.n_stages == len(set(names))
    for k, stage in enumerate(plan.schedule.stages):
        assert plan.stage_name(stage) == names[k]
        assert plan.stage_name(stage, index=k) == names[k]
    if CONFIGS[name].get("overlap") == "backward":
        assert all("/trigger=" in n for n in names)
    if not CONFIGS[name].get("sparse_as_dense"):
        assert any("bucket=leaf" in n for n in names)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_describe_equals_reference(name):
    plan, jplan = plans(name)
    for n in worker_levels(name) + [None]:
        assert plan.describe_schedule(n) == jplan.describe_schedule(n)
    want = jplan.describe().replace("| jax |", "| flat |")
    assert plan.describe() == want


def _stats_dict(stats):
    return {f.name: getattr(stats, f.name)
            for f in dataclasses.fields(stats)}


@pytest.mark.parametrize("profile", ["ib", "ethernet"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_exchange_stats_equal_reference(name, profile):
    kw = CONFIGS[name]
    opt = DistributedOptimizer(adamw(1e-3),
                               exchange=exchange.ExchangeConfig(**kw))
    jopt = JDistOpt(jadamw(1e-3),
                    exchange=jexchange.ExchangeConfig(**ref_kw(kw)))
    for n in worker_levels(name):
        got = opt.exchange_stats(port_grads(), n, profile=profile)
        want = jopt.exchange_stats(ref_grads(), n, profile=profile)
        assert _stats_dict(got) == _stats_dict(want), (name, n)
        assert got.describe() == want.describe()
        assert got.cost_profile == profile
    if not is_hier(name):
        none = opt.exchange_stats(port_grads(), 8, profile=None)
        assert none.predicted_comm_us == 0.0 and none.cost_profile == ""


# ---------------------------------------------------------------------------
# hooks: the disabled path is inert (tests/test_telemetry.py's cases)
# ---------------------------------------------------------------------------

def test_tap_identity_when_disabled():
    x = torch.arange(4.0)
    assert hooks.tap("pack", x) is x
    assert hooks.tracer() is None
    assert hooks.wire_recorder() is None


def test_stage_scope_nesting():
    assert hooks.current_stage() is None
    with hooks.stage_scope("outer"):
        assert hooks.current_stage() == "outer"
        with hooks.stage_scope("inner"):
            assert hooks.current_stage() == "inner"
        assert hooks.current_stage() == "outer"
    assert hooks.current_stage() is None


def test_double_install_raises():
    rec = hooks.WireRecorder()
    hooks.install_wire_recorder(rec)
    try:
        with pytest.raises(RuntimeError):
            hooks.install_wire_recorder(hooks.WireRecorder())
    finally:
        hooks.clear_wire_recorder()
    hooks.install_tracer(object())
    try:
        with pytest.raises(RuntimeError):
            hooks.install_tracer(object())
    finally:
        hooks.clear_tracer()
    assert hooks.wire_recorder() is None and hooks.tracer() is None


def test_record_collective_bills_current_stage():
    rec = hooks.WireRecorder()
    hooks.record_collective("all-reduce", 10)        # nothing installed
    hooks.install_wire_recorder(rec)
    try:
        hooks.record_collective("all-gather", 3)
        with hooks.stage_scope("s"):
            hooks.record_collective("all-reduce", 5)
            hooks.record_collective("all-reduce", 7)
    finally:
        hooks.clear_wire_recorder()
    assert rec.stage_wire_bytes() == {hooks.UNATTRIBUTED: 3.0, "s": 12.0}
    assert rec.total_collectives() == 3
    assert rec.as_dict()["per_stage"]["s"]["by_kind"] == {"all-reduce": 2}
