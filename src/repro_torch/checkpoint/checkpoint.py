"""Atomic, integrity-checked checkpoints of nested dicts of tensors — the
port of ``repro.checkpoint.checkpoint``, with its directory layout and
manifest schema:

    <dir>/step_<N>/
        manifest.json   — step, structure, leaf names and paths, shapes,
                          dtypes, crc32 of each leaf's bytes, user metadata
        <leaf>.npy      — one file per leaf

Leaves are flattened in the JAX package's order (dict keys sorted at every
level, as ``jax.tree`` flattens dicts) and named by the same rule (the key
path ``['a']['b']`` with every run of other characters than letters,
digits, ``_`` and ``.`` turned into ``_``), so a checkpoint the JAX
package's ``save_tree`` wrote from the same tree restores here to the same
values. Writes land in ``step_<N>.tmp`` and are renamed after the manifest
(written last); restores verify every checksum.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import shutil
import threading
import zlib

import numpy as np
import torch


def _flatten_with_paths(tree, path: str = "") -> list[tuple[str, object]]:
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in _flatten_with_paths(tree[key], f"{path}[{key!r}]")]
    return [(path, tree)]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {key: _unflatten(tree[key], it) for key in sorted(tree)}
    return next(it)


def _leaf_name(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.]+", "_", path).strip("_") or "leaf"


def _to_host(x) -> np.ndarray:
    """A leaf as a numpy array on the host (a copy of a device tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{key!r}: {_structure(tree[key])}" for key in sorted(tree)) + "}"
    return "*"


def save_tree(directory: str | pathlib.Path, step: int, tree,
              metadata: dict | None = None) -> pathlib.Path:
    """Atomically write one checkpoint. Returns the final directory."""
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "treedef": _structure(tree), "metadata": metadata or {},
                "leaves": []}
    names = set()
    for path, leaf in _flatten_with_paths(tree):
        name = _leaf_name(path)
        while name in names:
            name += "_"
        names.add(name)
        arr = _to_host(leaf)
        np.save(tmp / f"{name}.npy", arr)
        manifest["leaves"].append({
            "name": name,
            "path": path,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
        })
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def restore_tree(directory: str | pathlib.Path, step: int, like=None):
    """Restore (tree, metadata); verifies checksums.

    ``like``: a nested dict supplying the structure; each restored leaf
    becomes a tensor on the device of the ``like`` leaf it replaces (in
    flatten order). Without ``like``: (list of CPU tensors, metadata)."""
    ckpt = pathlib.Path(directory) / f"step_{step:08d}"
    with open(ckpt / "manifest.json") as f:
        manifest = json.load(f)
    arrays = []
    for leaf in manifest["leaves"]:
        arr = np.load(ckpt / f"{leaf['name']}.npy")
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
        if crc != leaf["crc32"]:
            raise IOError(f"checksum mismatch for {leaf['name']} in {ckpt} "
                          f"(expected {leaf['crc32']}, got {crc})")
        arrays.append(torch.from_numpy(arr).clone())   # torch-owned, torch-aligned
    if like is None:
        return arrays, manifest["metadata"]
    flat = [leaf for _, leaf in _flatten_with_paths(like)]
    if len(flat) != len(arrays):
        raise ValueError(f"leaf count mismatch: checkpoint has {len(arrays)}, "
                         f"template has {len(flat)}")
    moved = (a.to(t.device) if isinstance(t, torch.Tensor) else a for a, t in zip(arrays, flat))
    return _unflatten(like, moved), manifest["metadata"]


def _snapshot(x):
    """A host copy that the caller's later in-place updates cannot reach (on
    a CPU tensor ``.cpu()`` would return the same storage)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


@dataclasses.dataclass
class CheckpointManager:
    """Step-indexed checkpoint directory with retention.

    ``save_async`` copies every leaf to the host now and writes the files on
    a background thread, so the train step is not blocked by disk I/O; the
    copy is explicit, so the in-place optimizer step cannot reach the file
    being written. ``wait()`` joins the writer before a restore or exit."""

    directory: str | pathlib.Path
    keep: int = 3
    save_interval: int = 50

    def __post_init__(self):
        pathlib.Path(self.directory).mkdir(parents=True, exist_ok=True)
        self._pending = None
        self._pending_error = None

    def steps(self) -> list[int]:
        out = []
        for p in pathlib.Path(self.directory).glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval == 0

    def save(self, step: int, tree, metadata: dict | None = None):
        save_tree(self.directory, step, tree, metadata)
        self._gc()

    def save_async(self, step: int, tree, metadata: dict | None = None):
        """Non-blocking save: host copy now, write on a worker thread."""
        self.wait()
        snapshot = _unflatten(tree, (_snapshot(leaf) for _, leaf in _flatten_with_paths(tree)))
        self._pending_error = None

        def _write():
            try:
                save_tree(self.directory, step, snapshot, metadata)
                self._gc()
            except BaseException as e:  # surfaced in wait(), never swallowed
                self._pending_error = e

        self._pending = threading.Thread(target=_write, daemon=True)
        self._pending.start()

    def wait(self):
        """Join any in-flight async save (call before restore/exit).

        Re-raises any exception the writer thread hit: a checkpoint that
        failed silently must not pass for durable progress."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            err, self._pending_error = self._pending_error, None
            if err is not None:
                raise err

    def restore(self, like, step: int | None = None):
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        tree, meta = restore_tree(self.directory, step, like)
        return tree, meta, step

    def _gc(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(pathlib.Path(self.directory) / f"step_{s:08d}")
