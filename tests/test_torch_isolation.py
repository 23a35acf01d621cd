"""The port stands alone: neither ``repro_torch`` nor ``chip_smoke.py``
imports JAX or anything of the JAX package ``repro``."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_IMPORT_RE = re.compile(
    r"^\s*(?:import\s+(?P<imp>[\w.]+)|from\s+(?P<frm>[\w.]+)\s+import)", re.M
)


def _imported_roots(text):
    for m in _IMPORT_RE.finditer(text):
        yield (m.group("imp") or m.group("frm")).split(".")[0]


def test_sources_import_neither_jax_nor_repro():
    assert len(SOURCES) >= 20
    for path in SOURCES:
        roots = set(_imported_roots(path.read_text()))
        assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}, (path, roots)


def test_importing_the_port_loads_no_jax_and_no_repro():
    modules = []
    for path in sorted(PORT.rglob("*.py")):
        parts = ("repro_torch",) + path.relative_to(PORT).with_suffix("").parts
        modules.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for name in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "for need in ('repro_torch.core.simulator', 'repro_torch.models.lm',\n"
        "             'repro_torch.serve.step', 'repro_torch.kernels.ssd_scan.ops',\n"
        "             'repro_torch.jobs.engine', 'repro_torch.placement.wan',\n"
        "             'repro_torch.placement.replica', 'repro_torch.placement.controller',\n"
        "             'repro_torch.traces.drift', 'repro_torch.traces.faults',\n"
        "             'repro_torch.checkpoint.fault',\n"
        "             'repro_torch.benchmarks.placement_bench',\n"
        "             'repro_torch.serve.engine', 'repro_torch.launch.serve',\n"
        "             'repro_torch.benchmarks.serve_bench', 'repro_torch.models.attention',\n"
        "             'repro_torch.configs.qwen2_0_5b', 'repro_torch.configs.granite_3_2b',\n"
        "             'repro_torch.configs.phi4_mini', 'repro_torch.configs.stablelm_12b',\n"
        "             'repro_torch.models.moe', 'repro_torch.configs.deepseek_moe_16b',\n"
        "             'repro_torch.configs.phi35_moe', 'repro_torch.configs.hymba_1_5b',\n"
        "             'repro_torch.models.frontends', 'repro_torch.configs.hubert_xlarge',\n"
        "             'repro_torch.configs.internvl2_76b', 'repro_torch.benchmarks.run',\n"
        "             'repro_torch.examples.quickstart', 'repro_torch.examples.staged_jobs',\n"
        "             'repro_torch.examples.adaptive_placement',\n"
        "             'repro_torch.examples.serve_geo', 'repro_torch.traces.tokens',\n"
        "             'repro_torch.train.optimizer', 'repro_torch.train.step',\n"
        "             'repro_torch.checkpoint.checkpoint', 'repro_torch.launch.train',\n"
        "             'repro_torch.examples.train_lm', 'repro_torch.telemetry.ranges'):\n"
        "    assert need in sys.modules, need\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_to_run_without_cuda_or_the_repo(tmp_path):
    """Without CUDA (this test's machine) it exits non-zero and prints no
    result line; copied alone into an empty directory it fails too."""
    import torch

    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                             capture_output=True, text=True, timeout=300, cwd=ROOT)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
