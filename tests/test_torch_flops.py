"""The port's dispatch-level FLOP counter against the reference's jaxpr
walker, and ``param_counts`` / ``model_flops`` against the reference's.

  * the counterparts of tests/test_roofline_tools.py's counter tests
    (an exact product, loops multiplying, grad ~3x forward, the 6ND band);
  * the reduced config of each family (deepseek-7b, transformer-big,
    llama4-scout-17b-a16e, zamba2-7b, xlstm-125m, deepseek-v2-236b): the
    port's loss-plus-backward product FLOPs on meta tensors against the
    reference's ``dot_general`` FLOPs, product by product.  The
    reference side walks the jaxpr as ``repro.launch.flops.count_jaxpr``
    does, and also descends into nested ``jit`` equations, which that
    walker skips under the installed jax (its list has ``pjit``, the
    primitive's older name); in the layer scan of xlstm-125m it bills
    each ``cond`` branch for the layers that take it, where the walker
    bills the larger branch for every layer.  Where a family parts, the
    products are named below, with their source lines and cause;
  * every kernel wrapper's launch bills what its plain version counts;
  * ``param_counts`` and ``model_flops`` equal the reference's for all
    11 archs, and stay within the nameplate band of tests/test_dryrun.py.
"""
import collections
import os

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402
from jax._src import source_info_util         # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.launch import flops as jflops                     # noqa: E402
from repro.models import build_model as jbuild_model         # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa
from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.kernels.densify import densify_plain        # noqa: E402
from repro_torch.kernels.quantize import (                   # noqa: E402
    decode_sum_plain, quantize_ef_plain, quantize_plain)
from repro_torch.kernels.ssd import ssd_plain                # noqa: E402
from repro_torch.launch import dryrun, flops                 # noqa: E402
from repro_torch.models import build_model                   # noqa: E402
from repro_torch.telemetry import hooks                      # noqa: E402
from repro_torch.tree import tree_flatten, tree_unflatten    # noqa: E402

jax.config.update("jax_platform_name", "cpu")

META = torch.device("meta")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# the counter itself (tests/test_roofline_tools.py:13-106)
# ---------------------------------------------------------------------------

def test_dot_flops_exact():
    c = flops.count_fn_flops(lambda a, b: a @ b, meta(64, 32), meta(32, 128))
    assert c["flops"] == c["product_flops"] == 2 * 64 * 32 * 128
    assert c["bytes"] == 64 * 128 * 4
    ref = jflops.count_fn_flops(lambda a, b: a @ b,
                                jax.ShapeDtypeStruct((64, 32), jnp.float32),
                                jax.ShapeDtypeStruct((32, 128), jnp.float32))
    assert ref == {"flops": c["flops"], "bytes": c["bytes"]}


def test_loops_multiply():
    """An eager loop runs its body each trip: the reference's scan trip
    count multiplication, with no arithmetic (exact, not a band)."""
    def f(x, w):
        for i in range(w.shape[0]):
            x = x @ w[i]
        return x

    def nested(x, w):
        for i in range(w.shape[0]):
            for j in range(w.shape[1]):
                x = x @ w[i, j]
        return x
    assert flops.count_fn_flops(f, meta(8, 16), meta(12, 16, 16))[
        "product_flops"] == 12 * 2 * 8 * 16 * 16
    assert flops.count_fn_flops(nested, meta(4, 8), meta(3, 5, 8, 8))[
        "product_flops"] == 15 * 2 * 4 * 8 * 8


def test_grad_flops_approx_3x_forward():
    w = meta(64, 64).requires_grad_(True)
    x = meta(32, 64).requires_grad_(True)
    f = lambda: torch.sum(torch.tanh(x @ w))
    fwd = flops.count_fn_flops(f)["flops"]
    bwd = flops.count_fn_flops(
        lambda: torch.autograd.grad(f(), (w, x)))["flops"]
    assert 2.5 < bwd / fwd < 3.6


def test_model_flops_close_to_6nd():
    """The counted loss-plus-backward of the reduced deepseek-7b against
    6·N·D: a factor-2 band, as the reference's test holds."""
    cfg = get_config("deepseek-7b").reduced()
    b, s = 4, 64
    counted = port_products(cfg, b, s)[1]["flops"]
    _, n_active = dryrun.param_counts(cfg)
    assert 0.5 < counted / (6 * n_active * b * s) < 2.2


# ---------------------------------------------------------------------------
# the families against the reference's walker
# ---------------------------------------------------------------------------

_CALLS = ("jaxpr", "call_jaxpr", "fun_jaxpr")


def reference_products(arch: str, b: int, s: int, descend_jit: bool = True
                       ) -> collections.Counter:
    """``{(product flops, source file:line): count}`` of the reference's
    loss-plus-backward jaxpr on the reduced config: ``count_jaxpr``'s
    walk, and into nested ``jit`` equations when ``descend_jit``; a
    ``cond`` in the ssm family's layer scan bills each branch for the
    layers that take it (layer i is an sLSTM, branch 1, iff i %
    slstm_every == 1)."""
    cfg = jget_config(arch).reduced()
    model = jbuild_model(cfg)
    params = jax.eval_shape(model.init,
                            jax.eval_shape(lambda: jax.random.PRNGKey(0)))
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32),
             "labels": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    if cfg.frontend is not None:
        batch["frontend"] = jax.ShapeDtypeStruct(
            (b, cfg.frontend.n_embeds, cfg.d_model), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda p, bb: jax.grad(
        lambda pp: model.loss(pp, bb)[0])(p))(params, batch).jaxpr
    share = None
    if cfg.xlstm is not None:
        n_s = sum(i % cfg.xlstm.slstm_every == 1
                  for i in range(cfg.n_layers))
        share = ((cfg.n_layers - n_s) / cfg.n_layers, n_s / cfg.n_layers)
    out: collections.Counter = collections.Counter()
    calls = ("pjit", "closed_call", "custom_jvp_call", "custom_vjp_call",
             "custom_vjp_call_jaxpr", "remat", "remat2", "checkpoint",
             "custom_lin") + (("jit",) if descend_jit else ())

    def walk(jx, mult):
        for eqn in jx.eqns:
            name = eqn.primitive.name
            if name == "dot_general":
                fr = source_info_util.user_frame(eqn.source_info.traceback)
                where = (f"{os.path.relpath(fr.file_name, REPO)}:"
                         f"{fr.start_line}")
                out[(jflops._dot_flops(eqn), where)] += mult
            elif name == "scan":
                walk(eqn.params["jaxpr"].jaxpr, mult * eqn.params["length"])
            elif name == "while":
                walk(eqn.params["body_jaxpr"].jaxpr, mult)
            elif name == "cond":
                assert share is not None, "a cond outside the ssm family"
                for w, branch in zip(share, eqn.params["branches"]):
                    walk(branch.jaxpr, mult * w)
            elif name in calls:
                sub = next(eqn.params[k] for k in _CALLS
                           if eqn.params.get(k) is not None)
                walk(getattr(sub, "jaxpr", sub), mult)
    walk(jaxpr, 1)
    return out


class _Listing(flops.FlopCounter):
    """A FlopCounter that also lists each product's FLOPs."""

    def __init__(self):
        super().__init__()
        self.each = collections.Counter()

    def _count(self, func, args, out):
        if func.overloadpacket in flops._PRODUCTS:
            self.each[flops._PRODUCTS[func.overloadpacket](args)] += 1
        super()._count(func, args, out)


def port_products(cfg, b: int, s: int):
    """(each product's FLOPs, the count) of the port's loss and backward
    on meta tensors."""
    model = build_model(cfg)
    leaves, treedef = tree_flatten(model.init(device=META))
    leaves = [t.requires_grad_(True) for t in leaves]
    params = tree_unflatten(treedef, leaves)
    batch = {"tokens": meta(b, s, dtype=torch.int32),
             "labels": meta(b, s, dtype=torch.int32)}
    if cfg.frontend is not None:
        batch["frontend"] = meta(b, cfg.frontend.n_embeds, cfg.d_model)
    with _Listing() as c:
        torch.autograd.grad(model.loss(params, batch)[0], leaves,
                            allow_unused=True)
    return c.each, c.result()


#: per family, the reference's products the port computes without a
#: product: {FLOPs of one: how many}, and the reference lines they come
#: from.  Causes:
#:  * moe (scout, deepseek-v2): the grouped capacity dispatch builds its
#:    one-hot dispatch and combine masks with ``einsum``s
#:    (layers.py:467 "gtke,gtkc->gtec", :472 "gtke,gtkc,gtk->gtec",
#:    with their transposes in the backward); the port scatters the
#:    tokens into their slots and weights the combine with a broadcast
#:    multiply (at top-2, deepseek-v2's, only the contraction-free
#:    weighting "gtkc,gtk" and its transpose part);
#:  * hybrid (zamba2): the chunked SSD's contraction-free pairs of the
#:    three-operand einsums (ssm.py:154 "bcjn,bcjh,bcjhp", :173
#:    "bcin,bchnp,bcih") and their transposes: broadcast multiplies in
#:    the port's ``ssd_chunked``;
#:  * ssm (xlstm): the cotangent of the mLSTM's zero initial state in
#:    the first recurrent step (xlstm.py:62 "bhp,bhpo->bho"), which the
#:    reference's transposed scan computes and autograd skips (the
#:    initial state needs no gradient).
FAMILIES = {
    "deepseek-7b": ({}, ()),
    "transformer-big": ({}, ()),
    "llama4-scout-17b-a16e": ({40960.0: 6, 10240.0: 4},
                              ("src/repro/models/layers.py:467",
                               "src/repro/models/layers.py:472")),
    "zamba2-7b": ({65536.0: 24}, ("src/repro/models/ssm.py:154",
                                  "src/repro/models/ssm.py:173")),
    "xlstm-125m": ({65536.0: 1}, ("src/repro/models/xlstm.py:62",)),
    "deepseek-v2-236b": ({40960.0: 4}, ("src/repro/models/layers.py:472",)),
}
FAMILY_SHAPES = {"xlstm-125m": (2, 16)}


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_products_equal_reference(arch):
    b, s = FAMILY_SHAPES.get(arch, (2, 64))
    gap, lines = FAMILIES[arch]
    ref = reference_products(arch, b, s)
    each, port = port_products(get_config(arch).reduced(), b, s)
    ref_each = collections.Counter()
    for (f, _), n in ref.items():
        ref_each[f] += n
    ref_total = sum(f * n for (f, _), n in ref.items())
    assert port["product_flops"] == ref_total - sum(f * n for f, n in
                                                    gap.items())
    assert not each - ref_each, "products only the port computes"
    assert dict(ref_each - each) == gap
    # each reference-only product comes from one of the named lines
    missing = ref_each - each
    named = collections.Counter()
    for (f, where), n in ref.items():
        if where in lines:
            named[f] += n
    assert not missing - named, (missing, lines)


def test_reference_walker_skips_nested_jit():
    """``repro.launch.flops.count_jaxpr`` (flops.py:83) lists ``pjit``,
    and the installed jax calls the primitive ``jit``: the walker misses
    every product under a nested jit, here the chunked attention's QK^T
    and PV (kernels/ops.py), 2 x 2·b·h·s²·d a layer."""
    cfg = jget_config("deepseek-7b").reduced()
    b, s = 2, 64
    with_jit = reference_products("deepseek-7b", b, s)
    as_is = reference_products("deepseek-7b", b, s, descend_jit=False)
    missed = sum(f * n for (f, w), n in with_jit.items()) \
        - sum(f * n for (f, w), n in as_is.items())
    under_jit = sum(f * n for (f, w), n in with_jit.items()
                    if w.startswith("src/repro/kernels/ops.py"))
    hd = cfg.resolved_head_dim
    forward = cfg.n_layers * 2 * 2 * b * cfg.n_heads * s * s * hd
    assert missed == under_jit == 3 * forward     # forward + 2 in backward
    assert port_products(get_config("deepseek-7b").reduced(), b, s)[1][
        "product_flops"] == sum(f * n for (f, w), n in with_jit.items())


# ---------------------------------------------------------------------------
# kernel wrappers: a launch bills its plain version's count
# ---------------------------------------------------------------------------

def _wrapper_cases():
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    idx = torch.from_numpy(rng.integers(-3, 40, size=48).astype(np.int32))
    vals = t(48, 16).to(torch.bfloat16)
    flat = t(1000)
    x, dt = t(2, 64, 4, 8), torch.rand(2, 64, 4)
    a, bb, cc = -torch.rand(4), t(2, 64, 16), t(2, 64, 16)
    q, k = t(1, 64, 4, 16), t(1, 64, 2, 16)
    g = torch.from_numpy(rng.integers(-127, 128, size=3000).astype(np.int8))
    return {
        "densify": (ops.densify, (idx, vals, (32, 16)),
                    densify_plain, (idx, vals, (32, 16))),
        "quantize_int8": (ops.quantize_int8, (flat,), quantize_plain,
                          (flat,)),
        "quantize_int8_ef": (ops.quantize_int8_ef, (flat, torch.zeros(1000)),
                             quantize_ef_plain, (flat, torch.zeros(1000))),
        "int8_decode_sum": (ops.int8_decode_sum, (g, torch.rand(3), 3),
                            decode_sum_plain, (g, torch.rand(3), 3)),
        "ssd": (lambda *z: ops.ssd(*z, chunk=32), (x, dt, a, bb, cc),
                lambda *z: ssd_plain(*z, 32), (x, dt, a, bb, cc)),
        "flash_attention": (lambda *z: ops.flash_attention(*z, impl="kernel"),
                            (q, k, k), lambda *z: ops.chunked_attention(
                                *z, causal=True), (q, k, k)),
    }


@pytest.mark.parametrize("name", ["densify", "quantize_int8",
                                  "quantize_int8_ef", "int8_decode_sum",
                                  "ssd", "flash_attention"])
def test_launch_bills_the_plain_count(name, monkeypatch):
    """A wrapper on CPU tensors, on meta tensors, and a launch through
    ``ops._launch`` (a stand-in kernel that dispatches other ops of its
    own) all count what the plain version counts on the CPU; with no
    counter active the launch computes no work."""
    wrapper, args, plain, plain_args = _wrapper_cases()[name]
    want = flops.count_fn_flops(plain, *plain_args)
    assert want["bytes"] > 0
    assert flops.count_fn_flops(wrapper, *args) == want
    meta_args = [x.to(META) if isinstance(x, torch.Tensor) else x
                 for x in args]
    assert flops.count_fn_flops(wrapper, *meta_args) == want

    def kernel():                       # its own ops are set aside
        torch.ones(7, 7) @ torch.ones(7, 7)
        return plain(*plain_args)
    billed = flops.count_fn_flops(
        lambda: ops._launch(kernel, plain, *plain_args))
    assert billed == want
    calls = []
    monkeypatch.setattr(flops, "work_of",
                        lambda *a: calls.append(a) or (0.0, 0.0, 0.0))
    assert hooks.flop_counter() is None
    ops._launch(kernel, plain, *plain_args)
    assert calls == []


def test_densify_plain_drops_invalid_ids_as_before():
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.integers(-5, 45, size=200).astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal((200, 8)).astype(
        np.float32))
    want = torch.zeros(40, 8)
    for i, v in zip(idx.tolist(), vals):
        if 0 <= i < 40:
            want[i] += v
    got = densify_plain(idx, vals, (40, 8))
    assert got.shape == (40, 8)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_chunked_attention_count_does_not_depend_on_the_row_cap(
        monkeypatch):
    """The memory cap on the query rows (none on meta tensors) changes
    neither the result nor the product count: a causal block spans at
    most one kv chunk of rows, and skips the chunks past its last
    query."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 96, 2, 8)).astype(
        np.float32))
    whole = ops.chunked_attention(q, q, q, causal=True, block_k=32)
    on_meta = flops.count_fn_flops(ops.chunked_attention, q.to(META),
                                   q.to(META), q.to(META), True, None, 32)
    monkeypatch.setattr(ops, "SCORE_BLOCK_ELEMS", 2 * 32 * 8)
    capped = ops.chunked_attention(q, q, q, causal=True, block_k=32)
    torch.testing.assert_close(capped, whole, rtol=0, atol=0)
    on_cpu = flops.count_fn_flops(ops.chunked_attention, q, q, q, True,
                                  None, 32)
    assert on_cpu["product_flops"] == on_meta["product_flops"]
    full = 2 * 2 * 2 * 96 * 96 * 8
    assert on_meta["product_flops"] == full * (1 + 2 + 3) / 9


# ---------------------------------------------------------------------------
# param_counts / model_flops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_dryrun():
    """``repro.launch.dryrun``, imported with the environment restored:
    the module sets XLA_FLAGS (512 host devices) at import, which must
    not reach the subprocesses of other tests in this worker."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_equal_reference(arch,
                                                      reference_dryrun):
    assert dryrun.param_counts(get_config(arch)) == \
        reference_dryrun.param_counts(jget_config(arch))
    for shape in INPUT_SHAPES:
        assert dryrun.model_flops(arch, shape) == \
            reference_dryrun.model_flops(arch, shape)


def test_param_counts_sane():
    """tests/test_dryrun.py:61-78's nameplate band."""
    expect = {
        "llama3.2-1b": (1.24e9, 0.25),
        "deepseek-7b": (7e9, 0.25),
        "qwen2.5-32b": (32.8e9, 0.2),
        "deepseek-v2-236b": (236e9, 0.25),
        "xlstm-125m": (220e6, 0.15),
    }
    for arch, (target, tol) in expect.items():
        n, _ = dryrun.param_counts(get_config(arch))
        assert abs(n - target) / target < tol, (arch, n, target)
