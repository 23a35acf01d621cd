"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each kernel source under ``csrc/`` compiles into a shared library with a
plain C interface, loaded with :mod:`ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <lib> <source>

Libraries land in ``build/torch_kernels/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the source, of every file it
includes with ``#include "…"`` (the headers beside it under ``csrc/``, and
theirs in turn) and of the flags, so an edited source or header never loads
a stale build. A missing ``nvcc`` or a failed
compile raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "torch_kernels"

#: Every kernel of the port, by name -> its CUDA source.
SOURCES = {
    "gemm_f32": _KERNELS_DIR / "gemm_f32" / "csrc" / "gemm_f32.cu",
    "gmsa_score": _KERNELS_DIR / "gmsa_score" / "csrc" / "gmsa_score.cu",
    "ssd_scan": _KERNELS_DIR / "ssd_scan" / "csrc" / "ssd_scan.cu",
    "ssd_scan_bwd": _KERNELS_DIR / "ssd_scan" / "csrc" / "ssd_scan_bwd.cu",
}

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are built from source at first use"
    )


_QUOTED_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def quoted_includes(src: Path) -> list[Path]:
    """The files ``src`` includes with ``#include "…"``, each resolved
    against the directory of the file that includes it, and the files they
    include in turn: each once, in the order first met. Raises
    ``FileNotFoundError`` for one that does not exist."""
    found: list[Path] = []
    todo = [src]
    while todo:
        cur = todo.pop(0)
        for m in _QUOTED_INCLUDE.finditer(cur.read_bytes()):
            path = (cur.parent / m.group(1).decode()).resolve()
            if not path.is_file():
                raise FileNotFoundError(f'{cur}: #include "{m.group(1).decode()}" not found')
            if path not in found:
                found.append(path)
                todo.append(path)
    return found


def library_path(name: str) -> Path:
    """Where the build of kernel ``name`` lives, keyed by its source, the
    files that source includes (``quoted_includes``) and the flags."""
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes())
    for path in quoted_includes(src):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for kernel {name!r}:\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return log


def build_all(names=None) -> dict[str, str]:
    """Compile every named kernel (all by default), one ``nvcc`` each, all
    started together. Returns each kernel's compiler log ("" when the
    library was already built)."""
    names = list(SOURCES) if names is None else list(names)
    started = {n: _start(n) for n in names}
    return {n: ("" if s is None else _finish(n, s)) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib

