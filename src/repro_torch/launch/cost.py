"""What one pass of a step costs, counted op by op: the port's counterpart
of the reference's ``compiled.cost_analysis()`` and
``compiled.memory_analysis()``.

:class:`CostMode` is a ``TorchDispatchMode``: every ATen op of a pass run
under it (the forward, the autograd backward, the optimizer) is seen once,
below autograd, as the device would run it. On the ``meta`` device the ops
compute shapes only, so a full-width step is counted without allocating
anything; on real tensors the same ops give the same counts.

* ``flops``: the matmul-class ops priced by ``torch.utils.flop_counter``'s
  registry (mm, addmm, bmm, baddbmm, convolutions, the fused attention
  ops): 2·m·n·k a product. Elementwise work, reductions and the like are
  not counted, where XLA's ``cost_analysis()`` counts them too.
  ``flops_3xtf32`` is the part of them that the card computes as 3xTF32
  (the weight products ``matmul_f32`` gives the ``gemm_f32`` kernel,
  counted through :func:`as_3xtf32`), which the roofline prices apart.
* ``bytes``: every op that moves data adds the bytes of its tensor inputs
  and outputs (a broadcast dimension, stride 0, once). The port's program is eager and fuses nothing outside its
  kernels, so each such op reads its inputs from HBM and writes its
  outputs there. Views and aliases (an op that is not in place and whose
  outputs all share an input's storage) move nothing, and neither does an
  ``empty`` allocation.
* memory: the storages alive during the pass. The arguments' storages are
  registered first (:meth:`CostMode.hold`); each new storage an op returns
  is added when it appears and taken away when its last tensor dies (a
  ``weakref.finalize`` on the storage, which PyTorch keeps as one Python
  object while the storage lives). ``peak`` is the most bytes alive at
  once, the arguments included.

A hand-written kernel fuses its phases: off the card its wrapper runs the
kernel's plain version through :func:`as_kernel`, which counts that call
as the kernel: the plain version's FLOPs, but one op's bytes (its tensor
arguments read once, its outputs written once) and no storage alive but
the ones it returns (the kernel's workspaces and outputs), where the plain
version's own temporaries would otherwise stand in for the kernel's.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["CostMode", "as_3xtf32", "as_kernel"]

#: Allocations that write nothing.
_EMPTY_OPS = frozenset({
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.new_empty.default, torch.ops.aten.new_empty_strided.default,
    torch.ops.aten.empty_like.default,
})


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: a broadcast (stride-0)
    dimension is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes moved and live storage bytes over the ops run
    under it (see the module's docstring). After the pass: ``flops``,
    ``flops_3xtf32``, ``bytes``, ``ops`` (ATen calls seen), ``argument_bytes`` (storages held
    by :meth:`hold` or first seen as an input), ``peak_bytes`` and
    ``live_bytes``; :meth:`memory` gives the reference's four sizes."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_3xtf32 = 0
        self.bytes = 0
        self.ops = 0
        self.argument_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}      # id(storage) -> bytes, while it lives
        self._held: set[int] = set()         # the arguments' storages
        self._in_kernel = 0                  # depth of as_kernel calls

    def _track(self, storage, held: bool) -> None:
        key = id(storage)
        if key in self._live:
            return
        n = storage.nbytes()
        self._live[key] = n
        self.live_bytes += n
        if held:
            self._held.add(key)
            self.argument_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)
        self._held.discard(key)

    def hold(self, *trees) -> None:
        """Register the storages of the tensors in ``trees`` (nested
        dicts, lists, tuples) as the pass's arguments: alive from the
        start, counted in ``argument_bytes``."""
        for t in _tensors(list(trees)):
            self._track(t.untyped_storage(), held=True)

    def memory(self, outputs=()) -> dict:
        """``argument_bytes``, ``output_bytes`` (the storages of
        ``outputs``), ``temp_bytes`` (the peak less the arguments and the
        outputs that are not arguments) and ``peak_bytes``."""
        seen: dict[int, tuple[int, bool]] = {}
        for t in _tensors(outputs):
            s = t.untyped_storage()
            seen[id(s)] = (s.nbytes(), id(s) in self._held)
        out = sum(n for n, _ in seen.values())
        new_out = sum(n for n, held in seen.values() if not held)
        return {"argument_bytes": self.argument_bytes, "output_bytes": out,
                "temp_bytes": max(self.peak_bytes - self.argument_bytes - new_out, 0),
                "peak_bytes": self.peak_bytes}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket not in flop_registry:
            # A composite op that reaches the mode whole (``matmul`` under
            # inference mode) is counted by the ops it decomposes into.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        ins = [] if self._in_kernel else _tensors((args, kwargs))
        for t in ins:
            self._track(t.untyped_storage(), held=True)
        out = func(*args, **kwargs)
        self.ops += 1
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        if self._in_kernel:
            return out      # inside as_kernel: its bytes and storages are the call's
        outs = _tensors(out)
        in_ids = {id(t.untyped_storage()) for t in ins}
        aliases = not func._schema.is_mutable and all(
            id(o.untyped_storage()) in in_ids for o in outs)
        if not (func.is_view or aliases or func in _EMPTY_OPS):
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for o in outs:
            self._track(o.untyped_storage(), held=False)
        return out


def _innermost() -> CostMode | None:
    return next((m for m in reversed(_get_current_dispatch_mode_stack())
                 if isinstance(m, CostMode)), None)


def as_3xtf32(fn, *args):
    """``fn(*args)``, a product the card computes as 3xTF32, counted under
    the innermost active :class:`CostMode` as any other ops are, and its
    FLOPs besides in ``flops_3xtf32``. Without a CostMode it is
    ``fn(*args)``."""
    mode = _innermost()
    if mode is None:
        return fn(*args)
    before = mode.flops
    out = fn(*args)
    mode.flops_3xtf32 += mode.flops - before
    return out


def as_kernel(fn, *args):
    """``fn(*args)``, a kernel's plain version, counted as the kernel under
    the innermost active :class:`CostMode`: the FLOPs of the ops it runs;
    the bytes of one op (its tensor arguments and its returned tensors);
    alive afterwards only the storages it returns. Without a CostMode it is
    ``fn(*args)``."""
    mode = _innermost()
    if mode is None:
        return fn(*args)
    ins = _tensors(args)
    for t in ins:
        mode._track(t.untyped_storage(), held=True)
    mode._in_kernel += 1
    try:
        out = fn(*args)
    finally:
        mode._in_kernel -= 1
    outs = _tensors(out)
    mode.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
    for o in outs:
        mode._track(o.untyped_storage(), held=False)
    return out
