"""The Monte-Carlo ``runs`` axis in chunks on one device — the port of
``repro.distributed.mesh``.

The JAX package maps the (n_runs,) key axis of every ``*_many`` /
``sweep_*`` entry point over host devices with ``shard_map``. The port runs
on one card, so a mesh's runs axis of ``n`` parts is ``n`` chunks of
``ceil(R / n)`` runs, run one after another on the entry point's device:

* :class:`Mesh` — named axes and their sizes (no devices: one card is a
  world of size 1);
* :func:`runs_mesh` — a 1-D mesh whose ``"runs"`` axis has ``n`` parts;
* :func:`sharded_runs` — the chunk loop, with the reference's pad-and-slice.

Determinism contract (``shard_bench``'s): the runs' traces are drawn once,
for all runs, before the loop; each chunk slices that bundle, so every run
sees exactly the operands of the unchunked call, and the outputs are
bitwise identical at every chunk count, 1 and counts that do not divide R
included. A count that does not divide R pads the runs axis by repeating
the leading runs, as the reference pads its keys, and drops the surplus
rows from the gathered outputs, so summaries downstream weigh exactly the
real runs. A chunk's tensors are fresh copies (``index_select``), aligned
as a freshly drawn bundle is.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import Tensor

__all__ = ["RUNS_AXIS", "Mesh", "runs_mesh", "runs_parts", "sharded_runs", "take_runs"]

#: Mesh axis name carrying the Monte-Carlo runs dimension.
RUNS_AXIS = "runs"


class Mesh:
    """Named mesh axes and their sizes, as ``jax.make_mesh(sizes, names)``
    names them, without devices. ``shape`` maps each name to its size in
    axis order; ``axis_names`` is the names' tuple."""

    def __init__(self, sizes, names):
        sizes, names = tuple(int(s) for s in sizes), tuple(names)
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for {len(names)} axis names")
        if len(set(names)) != len(names):
            raise ValueError(f"axis names repeat: {names}")
        if any(s < 1 for s in sizes):
            raise ValueError(f"axis sizes must be >= 1, got {sizes}")
        self.axis_names = names
        self.shape = dict(zip(names, sizes))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def runs_mesh(n_chunks: int) -> Mesh:
    """A 1-D mesh whose ``"runs"`` axis has ``n_chunks`` parts."""
    n_chunks = int(n_chunks)
    if n_chunks < 1:
        raise ValueError(f"runs_mesh needs n_chunks >= 1, got {n_chunks}")
    return Mesh((n_chunks,), (RUNS_AXIS,))


def runs_parts(mesh: Mesh | None) -> int:
    """The number of chunks ``mesh`` cuts the runs axis into (1 without a
    mesh). A mesh without a ``"runs"`` axis raises."""
    if mesh is None:
        return 1
    if RUNS_AXIS not in mesh.shape:
        raise ValueError(
            f"a runs mesh needs axis {RUNS_AXIS!r}; got axes {tuple(mesh.axis_names)} "
            "(build one with runs_mesh())"
        )
    return mesh.shape[RUNS_AXIS]


def take_runs(x, sel: Tensor | None, axis: int = 0):
    """``x``'s runs ``sel`` along ``axis`` (``sel=None``: ``x`` itself).

    A fresh tensor laid out in memory as ``x`` is (a transposed view's
    chunk is transposed alike), so that operations downstream walk its
    elements in the order they walk ``x``'s; a broadcast runs axis (stride
    0: every run alike) stays broadcast. Non-tensors pass through."""
    if sel is None or not isinstance(x, Tensor):
        return x
    if x.stride(axis) == 0:
        return x.narrow(axis, 0, sel.numel())
    picked = x.index_select(axis, sel.to(x.device))
    if picked.stride() == x.narrow(axis, 0, sel.numel()).stride():
        return picked
    like = torch.empty_like(x.narrow(axis, 0, sel.numel()), memory_format=torch.preserve_format)
    return like.copy_(picked)


def _tree_map(fn, *trees):
    """``fn`` over the tensors of like-structured trees (named tuples,
    tuples, lists, dicts); ``None`` stays ``None``."""
    first = trees[0]
    if isinstance(first, Tensor):
        return fn(*trees)
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    raise TypeError(f"cannot gather outputs of type {type(first).__name__}")


def sharded_runs(one: Callable[[Tensor | None], Any], n_runs: int, mesh: Mesh,
                 axis: int = 0) -> Any:
    """Run ``one`` chunk by chunk over the runs axis of ``mesh``.

    ``one(sel)`` computes the outputs of the runs ``sel`` (an int64 index
    tensor into the (n_runs,) axis, on the CPU; :func:`take_runs` slices an
    operand by it) with their runs axis at ``axis``; ``sel=None`` means every
    run, in order, and is what a one-part mesh passes. With ``n`` parts the
    runs axis is padded to a multiple of ``n`` by repeating the leading runs
    and each of the ``n`` chunks of ``ceil(n_runs / n)`` runs runs in turn.
    Each chunk's outputs are copied into their rows of the result as the
    chunk ends (the padded rows are dropped), so the result, ``n_runs``
    along ``axis``, is held once beside one chunk's outputs.
    """
    n = runs_parts(mesh)
    if n == 1:
        return one(None)
    n_runs = int(n_runs)
    per = -(-n_runs // n)
    order = torch.arange(per * n) % n_runs          # padded: the leading runs repeat
    out = None
    for c in range(n):
        part = one(order[c * per:(c + 1) * per])
        lo, real = c * per, max(min(per, n_runs - c * per), 0)
        if out is None:
            out = _tree_map(lambda x: x.new_empty(
                x.shape[:axis] + (n_runs,) + x.shape[axis + 1:]), part)
        if real:
            _tree_map(lambda dst, src: dst.narrow(axis, lo, real).copy_(src.narrow(axis, 0, real)),
                      out, part)
        del part
    return out
