"""The port's tuning search (``repro_torch.tuning``, the fingerprint and
the plan cache of ``repro_torch.core.exchange``) against the reference's:

  * ``fingerprint(g, exact=...)`` equals ``repro.core.exchange.fingerprint``
    for the reduced transformer-big's gradient tree and for nested toy
    trees, exact and structural; the structural digest is the same at
    two batch sizes and the exact one is not; a fresh interpreter gives
    the same digest; a reconstructed tree hits the plan cache;
  * ``enumerate_space`` gives the reference's candidates field by field
    (its ``jax`` backend read as ``flat``) at P = 1, 2 and 8, with and
    without sparse contributions;
  * ``rank_candidates`` gives the reference's order and ``predicted_us``
    (relative 1e-12) under the four presets at P = 8;
  * the artifact: round trip, a stale version and unknown fields
    rejected, a miss returning None, and an artifact written by the
    reference's ``search`` and ``save_artifact`` resolving through the
    port's ``load_tuned_config`` to the same config;
  * the launcher's ``--tuned`` in a world of 1: a miss warns, searches
    and saves; the next launch resolves the artifact.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
import numpy as np                                            # noqa: E402

from repro.configs import get_config as jget_config            # noqa: E402
from repro.core import IndexedSlices as JSlices                # noqa: E402
from repro.core.exchange import fingerprint as jfingerprint    # noqa: E402
from repro.data import make_pipeline as jmake_pipeline         # noqa: E402
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.training.gradients import \
    abstract_grad_contributions                               # noqa: E402
from repro import tuning as jtuning                            # noqa: E402
from repro_torch.configs import get_config                     # noqa: E402
from repro_torch.core import (ExchangeConfig, IndexedSlices,   # noqa: E402
                              clear_plan_cache, compile_plan,
                              plan_cache_info)
from repro_torch.core.exchange import fingerprint              # noqa: E402
from repro_torch.data import make_pipeline                     # noqa: E402
from repro_torch.launch import train                           # noqa: E402
from repro_torch.models import build_model                     # noqa: E402
from repro_torch.training.gradients import \
    grad_contributions                                        # noqa: E402
from repro_torch import tuning                                 # noqa: E402
from repro_torch.tuning import space                           # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ("cpu", "ethernet", "ib", "tpu")
FIELDS = ("algorithm", "sparse_as_dense", "fusion_threshold",
          "reduce_scatter", "zero1", "param_codec", "codec", "backend",
          "hierarchy_levels", "use_kernel", "overlap")


def toy_trees(rows=6, v=32, d=8, sparse=True):
    """The same nested tree in both packages: a tied embedding's
    [IndexedSlices, IndexedSlices, dense] list, a nested dict of dense
    leaves (a bf16 one, a scalar)."""
    rng = np.random.default_rng(0)
    idx = [rng.integers(0, v, rows, dtype=np.int32) for _ in range(2)]
    val = [rng.standard_normal((rows, d)).astype(np.float32)
           for _ in range(2)]
    j = {"w1": jnp.zeros((64, 64)),
         "blk": {"b": jnp.zeros((64,), jnp.bfloat16), "a": jnp.zeros(())}}
    t = {"w1": torch.zeros(64, 64),
         "blk": {"b": torch.zeros(64, dtype=torch.bfloat16),
                 "a": torch.zeros(())}}
    if sparse:
        j["emb"] = [JSlices(jnp.asarray(i), jnp.asarray(x), (v, d))
                    for i, x in zip(idx, val)] + [jnp.zeros((v, d))]
        t["emb"] = [IndexedSlices(torch.from_numpy(i), torch.from_numpy(x),
                                  (v, d)) for i, x in zip(idx, val)] \
            + [torch.zeros(v, d)]
    return j, t


def model_trees(batch, seq=32):
    """The reduced transformer-big's gradient-contribution tree at
    ``batch`` x ``seq`` tokens: the reference's (abstract) and the
    port's (real, on the CPU)."""
    jcfg = jget_config("transformer-big").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in
          jmake_pipeline(jcfg, batch, seq).batch_at(0).items()}
    jg = abstract_grad_contributions(jmodel, jparams, jb,
                                     sparse_embedding=True)
    cfg = get_config("transformer-big").reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in
         make_pipeline(cfg, batch, seq).batch_at(0).items()}
    g = grad_contributions(model, params, b, sparse_embedding=True)[0]
    return jg, g


@pytest.fixture(scope="module")
def model_grads():
    return model_trees(2)


# -- fingerprints -----------------------------------------------------------

@pytest.mark.parametrize("exact", [True, False])
def test_fingerprint_equals_reference_on_the_model_tree(model_grads, exact):
    jg, g = model_grads
    assert fingerprint(g, exact=exact) == jfingerprint(jg, exact=exact)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("sparse", [True, False])
def test_fingerprint_equals_reference_on_a_nested_tree(exact, sparse):
    j, t = toy_trees(sparse=sparse)
    assert fingerprint(t, exact=exact) == jfingerprint(j, exact=exact)


def test_structural_fingerprint_ignores_the_batch_size(model_grads):
    jg4, g4 = model_trees(4)
    _, g2 = model_grads
    assert fingerprint(g2, exact=False) == fingerprint(g4, exact=False)
    assert fingerprint(g2) != fingerprint(g4)
    assert fingerprint(g4) == jfingerprint(jg4)
    assert compile_plan(g2, ExchangeConfig()).fingerprint == fingerprint(g2)


def test_fingerprint_same_in_a_fresh_process():
    code = (
        "import torch\n"
        "from repro_torch.core import IndexedSlices\n"
        "from repro_torch.core.exchange import fingerprint\n"
        "s = IndexedSlices(torch.zeros(4, dtype=torch.int32),\n"
        "                  torch.zeros(4, 8), (32, 8))\n"
        "t = {'e': [s, torch.zeros(32, 8)], 'w': torch.zeros(16)}\n"
        "print(fingerprint(t), fingerprint(t, exact=False))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    s = JSlices(jnp.zeros(4, jnp.int32), jnp.zeros((4, 8)), (32, 8))
    jt = {"e": [s, jnp.zeros((32, 8))], "w": jnp.zeros((16,))}
    want = f"{jfingerprint(jt)} {jfingerprint(jt, exact=False)}\n"
    assert out.stdout == want


def test_plan_cache_hits_a_reconstructed_tree():
    clear_plan_cache()
    cfg = ExchangeConfig(sparse_as_dense=True)
    p1 = compile_plan(toy_trees()[1], cfg)
    p2 = compile_plan(toy_trees()[1], cfg)
    assert p1 is p2
    assert plan_cache_info() == {"hits": 1, "misses": 1, "size": 1}
    compile_plan(toy_trees(rows=9)[1], cfg)        # rows: another plan
    assert plan_cache_info()["misses"] == 2
    clear_plan_cache()
    assert plan_cache_info() == {"hits": 0, "misses": 0, "size": 0}


# -- the space --------------------------------------------------------------

def _fields(c):
    """A candidate's config fields and fold, the reference's backend
    name ``jax`` read as ``flat``."""
    cfg = c.config
    return tuple({"jax": "flat"}.get(v, v) if f == "backend" else v
                 for f, v in ((f, getattr(cfg, f)) for f in FIELDS)) \
        + (c.levels,)


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("n_workers", [1, 2, 8])
def test_enumerate_space_equals_reference(n_workers, sparse):
    j, t = toy_trees(sparse=sparse)
    want = [_fields(c) for c in jtuning.enumerate_space(j, n_workers)]
    got = [_fields(c) for c in tuning.enumerate_space(t, n_workers)]
    assert got == want
    assert len(got) > 20
    assert any(not f[1] for f in got) == sparse     # the gather axis
    assert any(f[7] == "hierarchical" for f in got) == (n_workers == 8)


# -- the rank ---------------------------------------------------------------

@pytest.mark.parametrize("profile", PRESETS)
def test_rank_equals_reference(model_grads, profile):
    jg, g = model_grads
    want = jtuning.rank_candidates(jtuning.enumerate_space(jg, 8), jg,
                                   profile)
    got = tuning.rank_candidates(tuning.enumerate_space(g, 8), g, profile)
    assert [c.label for c in got] == [
        c.label.replace("/jax/", "/flat/") for c in want]
    for a, b in zip(got, want):
        assert a.predicted_us == pytest.approx(b.predicted_us, rel=1e-12)


def test_rank_ties_fall_in_the_reference_order(monkeypatch):
    """Where predictions tie exactly, the overlap preference and then the
    label order the candidates.  With every prediction equal, the port's
    rank must still be the reference's: it sorts on the label the
    reference gives a config (``jax``, which sorts after
    ``hierarchical``), not on its own (``flat``, which sorts before)."""
    from repro.tuning import cost as jcost
    from repro_torch.tuning import cost
    monkeypatch.setattr(jcost, "predict_comm_us", lambda *a, **k: 1.0)
    monkeypatch.setattr(cost, "predict_comm_us", lambda *a, **k: 1.0)
    j, t = toy_trees()
    want = jtuning.rank_candidates(jtuning.enumerate_space(j, 8), j, "tpu")
    got = tuning.rank_candidates(tuning.enumerate_space(t, 8), t, "tpu")
    assert [c.label for c in got] == [
        c.label.replace("/jax/", "/flat/") for c in want]
    by_port_label = sorted(got, key=lambda c: (
        {False: 2, "staged": 1, "backward": 0}[c.config.overlap], c.label))
    assert [c.label for c in by_port_label] != [c.label for c in got]
    assert space.reference_label(got[0].config) == \
        got[0].label.replace("/flat/", "/jax/")


# -- artifacts --------------------------------------------------------------

def _toy_search(t):
    return tuning.search(t, 8, profile="ethernet", trials=0,
                         codecs=("identity", "int8"), thresholds=(None,),
                         include_reduce_scatter=False)


def test_artifact_roundtrip_and_miss(tmp_path):
    _, t = toy_trees()
    res = _toy_search(t)
    path = tuning.save_artifact(res, str(tmp_path))
    doc = tuning.load_artifact(path)
    assert doc["winner_label"] == res.winner.label
    assert doc["key"] == res.key == tuning.artifact_key(t, 8, "ethernet")
    hit = tuning.load_tuned_config(t, 8, "ethernet", str(tmp_path))
    assert hit is not None and hit["path"] == path
    assert hit["exchange_config"] == res.winner.config
    # the structural key: another batch size of the same tree hits
    assert tuning.load_tuned_config(toy_trees(rows=11)[1], 8, "ethernet",
                                    str(tmp_path)) is not None
    # another worker count or profile is a clean miss
    assert tuning.load_tuned_config(t, 4, "ethernet", str(tmp_path)) is None
    assert tuning.load_tuned_config(t, 8, "ib", str(tmp_path)) is None
    pred = [c.predicted_us for c in res.candidates]
    assert pred == sorted(pred) and res.winner is res.candidates[0]
    assert res.table().count("|") > 10


def test_artifact_stale_version_and_unknown_fields_rejected(tmp_path):
    _, t = toy_trees()
    path = tuning.save_artifact(_toy_search(t), str(tmp_path))
    doc = json.loads(open(path).read())
    with open(path, "w") as f:
        json.dump(dict(doc, version=999), f)
    with pytest.raises(tuning.TuningArtifactError, match="stale"):
        tuning.load_artifact(path)
    assert tuning.load_tuned_config(t, 8, "ethernet", str(tmp_path)) is None
    with pytest.raises(tuning.TuningArtifactError, match="unknown fields"):
        tuning.config_from_dict(dict(doc["winner"], warp=9))
    with pytest.raises(tuning.TuningArtifactError, match="no tuning"):
        tuning.load_artifact(str(tmp_path / "missing.json"))


def test_reference_artifact_resolves_in_the_port(tmp_path):
    j, t = toy_trees()
    res = jtuning.search(j, 8, profile="ethernet", trials=0,
                         codecs=("identity", "int8"), thresholds=(None,),
                         include_reduce_scatter=False)
    jtuning.save_artifact(res, str(tmp_path))
    hit = tuning.load_tuned_config(t, 8, "ethernet", str(tmp_path))
    assert hit is not None and hit["key"] == res.key
    want = dict(jtuning.config_to_dict(res.winner.config))
    want["backend"] = {"jax": "flat"}.get(want["backend"], want["backend"])
    assert tuning.config_to_dict(hit["exchange_config"]) == want
    # the winner the port's own search picks on the same tree
    assert hit["exchange_config"] == _toy_search(t).winner.config


# -- the launcher -----------------------------------------------------------

def test_tuned_launch_falls_back_then_resolves(tmp_path, capsys):
    argv = ["--reduced", "--dist", "horovod", "--steps", "1",
            "--log-every", "1", "--batch-per-worker", "2", "--seq-len",
            "16", "--device", "cpu", "--tuned", "--tune-cache",
            str(tmp_path)]
    first = []
    train.run(argv, log=first.append)
    err = capsys.readouterr().err
    assert "falling back to analytic search" in err
    assert any(s.startswith("tuned exchange (analytic, cached -> ")
               for s in first)
    assert len(os.listdir(tmp_path)) == 1
    second = []
    res = train.run(argv, log=second.append)
    assert "falling back" not in capsys.readouterr().err
    assert any(s.startswith("tuned exchange: ") for s in second)
    assert any("predicted_comm_us" in s for s in second)
    assert np.isfinite(res["history"][-1]["loss"])
