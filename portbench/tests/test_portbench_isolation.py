"""What the benchmark imports: nothing whose top-level name is ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` (compared whole:
``repro_torch`` is the program), and the plain references nothing of the
program either."""

import re
import subprocess
import sys

from conftest import ROOT

BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
_IMPORT = re.compile(r"^\s*(?:import\s+([\w.]+)|from\s+([\w.]+)\s+import)", re.M)


def roots(path):
    return {(a or b).split(".")[0] for a, b in _IMPORT.findall(path.read_text())}


def modules(folder):
    for path in sorted(folder.rglob("*.py")):
        if "tests" not in path.relative_to(BENCH).parts:
            yield path


def test_no_source_imports_jax_or_the_jax_package():
    for path in modules(BENCH):
        assert not roots(path) & FORBIDDEN, path


def test_the_references_import_nothing_of_the_program():
    allowed = {"__future__", "contextlib", "importlib", "math", "time", "torch", "portbench"}
    for path in modules(BENCH / "reference"):
        assert roots(path) <= allowed, (path, roots(path) - allowed)


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_importing_the_benchmark_loads_no_jax():
    names, readers = [], []
    for path in modules(BENCH):
        rel = path.relative_to(ROOT).with_suffix("")
        if rel.parts[1] in ("metrics", "e2e"):
            readers.append(str(path))
        else:
            names.append(".".join(p for p in rel.parts if p != "__init__"))
    code = (
        "import sys, importlib\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "from pathlib import Path\n"
        "from portbench.harness import load_reader\n"
        f"for f in {readers!r}:\n"
        "    load_reader(Path(f))\n"
        "import repro_torch.serve.step, repro_torch.train.step\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = _loaded_after(code)
    assert "repro_torch" in top and not top & FORBIDDEN


def test_the_references_load_nothing_of_the_program():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}]\n"
        "import portbench.reference.lm, portbench.reference.mamba2, portbench.reference.hymba\n"
        "import portbench.reference.ops, portbench.inputs\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    top = _loaded_after(code)
    assert "portbench" in top and not top & (FORBIDDEN | {"repro_torch"})
