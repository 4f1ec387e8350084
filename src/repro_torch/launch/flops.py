"""Dispatch-level FLOP counting (the port's ``repro.launch.flops``).

The reference walks a jaxpr: ``dot_general`` and ``conv`` FLOPs from
shapes, multiplied through ``scan`` trip counts, elementwise ops at 1
FLOP an element, and the output bytes of every equation.  The port runs
eagerly, so ``FlopCounter`` is a ``TorchDispatchMode`` that sees every
aten op the program actually dispatches, loops included (no trip-count
arithmetic), and counts:

  * every product at 2·b·m·n·k (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    ``addbmm``, ``mv``, ``addmv``, ``dot``, ``vdot``, ``addr``; the
    fused add of the ``add*`` forms at 1 an output element);
    ``product_flops`` holds these alone;
  * convolutions as the reference does: 2 x output elements x the
    weight's elements past its first dim;
  * the reference's ``ELEMENTWISE_1`` set, mapped to aten ops
    (``ELEMENTWISE_ATEN``), at 1 FLOP an output element;
  * ``bytes``: the output bytes of every op but views and bare
    allocations (``empty``), which write nothing in eager PyTorch.

On DTensors (the partitioned step, ``launch.partitioned``) the counter
lets DTensor dispatch and counts the local ops it runs: one rank's work,
the ops of its redistributions included; the fake tensors of DTensor's
shape propagation are not counted.

A hand-written kernel's launch is invisible to the dispatcher.  Its
wrapper (``kernels/ops.py``) therefore launches through ``billed``: while
a counter is active the ops of the launch go uncounted and the work of
its plain version on the same shapes (``work_of``, counted once on meta
tensors and cached) is billed instead, so a step counts the same FLOPs
whichever route implements it.  With no counter active that costs one
global read (``telemetry.hooks.flop_counter``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.telemetry import hooks
from repro_torch.telemetry.hooks import record_work

__all__ = ["ELEMENTWISE_1", "ELEMENTWISE_ATEN", "FlopCounter",
           "count_fn_flops", "record_work", "billed", "work_of"]

aten = torch.ops.aten

#: the reference's elementwise primitives (``repro.launch.flops``)
ELEMENTWISE_1 = {
    "add", "sub", "mul", "div", "max", "min", "neg", "exp", "log",
    "tanh", "logistic", "rsqrt", "sqrt", "pow", "integer_pow",
    "erf", "abs", "sign", "floor", "ceil", "round", "cos", "sin",
    "select_n", "clamp", "and", "or", "not", "xor", "rem",
    "log1p", "expm1", "cumsum", "cumlogsumexp",
}

#: each of them as the aten ops (in-place forms included) that compute it
ELEMENTWISE_ATEN: Dict[str, Tuple[str, ...]] = {
    "add": ("add",), "sub": ("sub", "rsub"), "mul": ("mul",),
    "div": ("div",), "max": ("maximum", "clamp_min"),
    "min": ("minimum", "clamp_max"), "neg": ("neg",), "exp": ("exp",),
    "log": ("log",), "tanh": ("tanh",), "logistic": ("sigmoid",),
    "rsqrt": ("rsqrt",), "sqrt": ("sqrt",), "pow": ("pow",),
    "integer_pow": ("pow",), "erf": ("erf",), "abs": ("abs",),
    "sign": ("sign",), "floor": ("floor",), "ceil": ("ceil",),
    "round": ("round",), "cos": ("cos",), "sin": ("sin",),
    "select_n": ("where",), "clamp": ("clamp",),
    "and": ("bitwise_and", "logical_and"),
    "or": ("bitwise_or", "logical_or"),
    "not": ("bitwise_not", "logical_not"),
    "xor": ("bitwise_xor", "logical_xor"), "rem": ("remainder", "fmod"),
    "log1p": ("log1p",), "expm1": ("expm1",), "cumsum": ("cumsum",),
    "cumlogsumexp": ("logcumsumexp",),
}


def _packets(names) -> set:
    out = set()
    for n in names:
        for name in (n, n + "_"):
            p = getattr(aten, name, None)
            if p is not None:
                out.add(p)
    return out


_ELEMENTWISE = _packets(n for v in ELEMENTWISE_ATEN.values() for n in v)
_NO_BYTES = _packets(("empty", "empty_strided", "empty_like", "new_empty",
                      "new_empty_strided"))


def _numel(t) -> int:
    return math.prod(t.shape)


def _mm(a, b) -> float:
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[-1]


def _bmm(a, b) -> float:
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[-1]


# product op -> its product FLOPs, from its arguments
_PRODUCTS: Dict[Any, Callable] = {
    aten.mm: lambda a: _mm(a[0], a[1]),
    aten.addmm: lambda a: _mm(a[1], a[2]),
    aten.bmm: lambda a: _bmm(a[0], a[1]),
    aten.baddbmm: lambda a: _bmm(a[1], a[2]),
    aten.addbmm: lambda a: _bmm(a[1], a[2]),
    aten.mv: lambda a: 2.0 * _numel(a[0]),
    aten.addmv: lambda a: 2.0 * _numel(a[1]),
    aten.dot: lambda a: 2.0 * _numel(a[0]),
    aten.vdot: lambda a: 2.0 * _numel(a[0]),
    aten.addr: lambda a: 2.0 * _numel(a[1]) * _numel(a[2]),
}
_FUSED_ADD = {aten.addmm, aten.baddbmm, aten.addbmm, aten.addmv, aten.addr}


def _skipped(types):
    """"dtensor" when a DTensor is among ``types``, "fake" for the fake
    tensors of DTensor's shape propagation (not part of the run), else
    None."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    for t in types:
        if issubclass(t, DTensor):
            return "dtensor"
        if issubclass(t, FakeTensor):
            return "fake"
    return None


class FlopCounter(TorchDispatchMode):
    """Counts what runs inside ``with FlopCounter() as c:`` (see the
    module docstring); ``c.result()`` gives ``{"flops", "bytes",
    "product_flops"}``."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.product_flops = 0.0
        self.paused = 0

    def __enter__(self):
        super().__enter__()
        hooks.push_flop_counter(self)
        return self

    def __exit__(self, *exc):
        hooks.pop_flop_counter(self)
        return super().__exit__(*exc)

    def add(self, flops: float, nbytes: float,
            product_flops: float = 0.0) -> None:
        self.flops += flops
        self.bytes += nbytes
        self.product_flops += product_flops

    def result(self) -> Dict[str, float]:
        return {"flops": self.flops, "bytes": self.bytes,
                "product_flops": self.product_flops}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        skip = _skipped(types)
        if skip == "dtensor":
            # a DTensor runs its local ops, which come back here: a
            # partitioned step counts this rank's work
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not self.paused and not skip:
            self._count(func, args, out)
        return out

    def _count(self, func, args, out) -> None:
        packet = func.overloadpacket
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if packet in _PRODUCTS:
            f = _PRODUCTS[packet](args)
            self.product_flops += f
            self.flops += f
            if packet in _FUSED_ADD:
                self.flops += _numel(outs[0])
        elif packet is aten.convolution:
            self.flops += 2.0 * _numel(outs[0]) * math.prod(args[1].shape[1:])
        elif packet is aten.convolution_backward:
            # the input's and the weight's gradient, as the forward each
            per = 2.0 * _numel(args[0]) * math.prod(args[2].shape[1:])
            self.flops += per * sum(bool(m) for m in args[10][:2])
        elif packet in _ELEMENTWISE:
            self.flops += sum(_numel(t) for t in outs)
        if not func.is_view and packet not in _NO_BYTES:
            self.bytes += sum(_numel(t) * t.element_size() for t in outs)


def count_fn_flops(fn, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` once under a ``FlopCounter`` (meta
    tensors count without memory or compute) -> ``{"flops", "bytes",
    "product_flops"}``."""
    with FlopCounter() as c:
        fn(*args, **kwargs)
    return c.result()


def billed(run: Callable, work: Callable):
    """``run()`` launches a kernel; while a FLOP counter is active the
    ops it dispatches go uncounted and ``work()`` -> ``(flops, bytes,
    product_flops)`` is billed in their place."""
    c = hooks.flop_counter()
    if c is None:
        return run()
    c.paused += 1
    try:
        out = run()
        w = work()
    finally:
        c.paused -= 1
    hooks.record_work(*w)
    return out


_WORK: Dict[tuple, Tuple[float, float, float]] = {}


def _meta_like(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                   dtype=x.dtype, device="meta")
    return x


def _signature(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), tuple(x.stride()), x.dtype)
    return x


def work_of(fn: Callable, *args, **kwargs) -> Tuple[float, float, float]:
    """``(flops, bytes, product_flops)`` that ``fn`` counts on meta
    tensors of ``args``' shapes, strides and dtypes; cached by them."""
    key = (fn, tuple(_signature(a) for a in args),
           tuple(sorted((k, _signature(v)) for k, v in kwargs.items())))
    if key not in _WORK:
        r = count_fn_flops(fn, *tree_map(_meta_like, list(args)),
                           **tree_map(_meta_like, kwargs))
        _WORK[key] = (r["flops"], r["bytes"], r["product_flops"])
    return _WORK[key]
