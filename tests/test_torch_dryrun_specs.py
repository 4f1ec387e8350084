"""The dry run's mesh, input specs and sharding rules against the JAX
package's (``repro.launch.{mesh,specs,sharding}``).

  * every parameter leaf's spec of the 11 archs on both production
    meshes, (16, 16) and (2, 16, 16), with and without FSDP: the
    reference's ``params_shardings`` runs on a stub mesh that carries
    only ``axis_names`` and ``devices.shape`` (all it reads,
    sharding.py:20-21) with ``NamedSharding`` replaced by its spec;
  * ``batch_shardings`` and ``cache_shardings`` on decode_32k and
    long_500k the same way;
  * the shapes and dtypes of ``input_specs`` and ``decode_specs`` for
    every arch and input shape, against ``jax.eval_shape``;
  * one leaf's per-device bytes by hand, its DTensor placements, and the
    production mesh as a ``DeviceMesh`` over a fake world of 256.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import numpy as np                            # noqa: E402
from jax.sharding import PartitionSpec        # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.configs import INPUT_SHAPES as JINPUT_SHAPES      # noqa: E402
from repro.launch import sharding as jsharding               # noqa: E402
from repro.launch import specs as jspecs                     # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa
from repro_torch.launch import dryrun, mesh, sharding, specs  # noqa: E402
from repro_torch.tree import tree_leaves_with_path           # noqa: E402

jax.config.update("jax_platform_name", "cpu")

MESHES = {"1pod": False, "2pod": True}


def stub_mesh(spec: mesh.MeshSpec):
    return types.SimpleNamespace(axis_names=spec.axis_names,
                                 devices=np.empty(spec.shape))


@pytest.fixture(autouse=True)
def specs_not_shardings(monkeypatch):
    """The reference's rules return their PartitionSpecs."""
    monkeypatch.setattr(jsharding, "NamedSharding", lambda m, spec: spec)


def ref_leaves(tree):
    """``(keystr path, leaf)`` of a reference tree, PartitionSpecs as
    leaves."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return [(jax.tree_util.keystr(p), x) for p, x in flat]


def padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def same_specs(ref_specs, ref_tree, port_specs):
    """Every leaf's spec equal (the reference's padded to the leaf's
    rank), leaf paths equal."""
    ref = ref_leaves(ref_specs)
    shapes = dict((p, x.shape) for p, x in ref_leaves(ref_tree))
    port = tree_leaves_with_path(port_specs)
    assert [p for p, _ in ref] == [p for p, _ in port]
    for (path, r), (_, got) in zip(ref, port):
        assert got == padded(r, len(shapes[path])), path
    return len(port)


@pytest.fixture(scope="module")
def structs():
    """Full-width params of every arch: eval_shape and meta tensors."""
    return {arch: (jspecs.params_structs(jget_config(arch)),
                   specs.params_structs(get_config(arch)))
            for arch in ARCH_IDS}


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("pod", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, pod, fsdp, structs):
    spec = mesh.make_production_mesh(multi_pod=MESHES[pod])
    jparams, params = structs[arch]
    n = same_specs(jsharding.params_shardings(jparams, stub_mesh(spec),
                                              fsdp=fsdp), jparams,
                   sharding.params_shardings(params, spec, fsdp=fsdp))
    assert n == len(jax.tree_util.tree_leaves(jparams))
    # the rules shard something of every arch
    assert any(any(e is not None for e in s) for _, s in
               tree_leaves_with_path(sharding.params_shardings(
                   params, spec, fsdp=fsdp)))


@pytest.mark.parametrize("pod", list(MESHES))
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_reference(arch, shape, pod):
    spec = mesh.make_production_mesh(multi_pod=MESHES[pod])
    stub = stub_mesh(spec)
    jtoks, jcache, _, _ = jspecs.decode_specs(jget_config(arch),
                                              JINPUT_SHAPES[shape])
    toks, cache, _, _ = specs.decode_specs(get_config(arch),
                                           INPUT_SHAPES[shape])
    batch = INPUT_SHAPES[shape].global_batch
    same_specs(jsharding.cache_shardings(jcache, stub, batch), jcache,
               sharding.cache_shardings(cache, spec, batch))
    for shard_seq in (False, True):
        same_specs(jsharding.batch_shardings(jtoks, stub, shard_seq),
                   jtoks, sharding.batch_shardings(toks, spec, shard_seq))
    jin = jspecs.input_specs(jget_config(arch), JINPUT_SHAPES["train_4k"])
    same_specs(jsharding.batch_shardings(jin, stub), jin,
               sharding.batch_shardings(
                   specs.input_specs(get_config(arch),
                                     INPUT_SHAPES["train_4k"]), spec))


def same_structs(ref, port):
    ref, port = ref_leaves(ref), tree_leaves_with_path(port)
    assert [p for p, _ in ref] == [p for p, _ in port]
    for (path, r), (_, t) in zip(ref, port):
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(r.shape), path
        assert str(t.dtype).split(".")[-1] == str(r.dtype), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_decode_specs_equal_reference(arch):
    for shape in INPUT_SHAPES:
        jcfg, cfg = jget_config(arch), get_config(arch)
        if INPUT_SHAPES[shape].kind == "decode":
            jt, jc, jw, jr = jspecs.decode_specs(jcfg, JINPUT_SHAPES[shape])
            t, c, w, r = specs.decode_specs(cfg, INPUT_SHAPES[shape])
            assert (w, r) == (jw, jr)
            same_structs(jt, t)
            same_structs(jc, c)
        else:
            same_structs(jspecs.input_specs(jcfg, JINPUT_SHAPES[shape]),
                         specs.input_specs(cfg, INPUT_SHAPES[shape]))


def test_one_leaf_by_hand(structs):
    """llama3.2-1b's stacked wq (16 layers, 2048 x 2048 bf16) on the
    (16, 16) mesh with FSDP: the output dim over ('model', 'data'), 2048
    / 256 = 8 columns a device."""
    spec = mesh.make_production_mesh()
    params = structs["llama3.2-1b"][1]
    wq = params["layers"]["attn"]["wq"]
    assert tuple(wq.shape) == (16, 2048, 2048)
    s = sharding.params_shardings(params, spec)["layers"]["attn"]["wq"]
    assert s == (None, None, ("model", "data"))
    assert sharding.shard_shape(wq.shape, s, spec) == (16, 2048, 8)
    assert sharding.shard_bytes({"wq": wq}, {"wq": s}, spec) \
        == 16 * 2048 * 8 * 2
    from torch.distributed.tensor import Replicate, Shard
    assert sharding.placements(s, spec) == (Shard(2), Shard(2))
    assert sharding.placements((None,) * 3, spec) == (Replicate(),) * 2


def test_production_meshes_and_device_mesh():
    one = mesh.make_production_mesh()
    two = mesh.make_production_mesh(multi_pod=True)
    assert (one.shape, one.axis_names) == ((16, 16), ("data", "model"))
    assert (two.shape, two.axis_names) == ((2, 16, 16),
                                           ("pod", "data", "model"))
    assert mesh.data_axes(two) == ("pod", "data")
    assert mesh.make_mesh([4, 2], ["data", "model"]).size == 8
    from repro_torch.tuning.profile import get_profile
    assert mesh.PEAK_FLOPS_BF16 == get_profile("tpu").peak_flops
    with pytest.raises(RuntimeError, match="world"):
        mesh.device_mesh(one, "cpu")
    with dryrun.fake_world(256):
        dm = mesh.device_mesh(one, "cpu")
        assert tuple(dm.shape) == (16, 16)
        assert dm.mesh_dim_names == ("data", "model")
