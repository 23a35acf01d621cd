"""The port's kernel build keys: a library's path follows its source, the
headers that source includes and the flags, so that an edited header never
loads a stale library. No nvcc is needed: only the paths are computed, on
copies of the sources under ``tmp_path`` (``_build.SOURCES`` patched)."""

import re
import shutil

import pytest

from repro_torch.kernels import _build

SSD_LIBS = ("ssd_scan", "ssd_scan_bwd")


@pytest.fixture
def copied(tmp_path, monkeypatch):
    """Every kernel source's ``csrc`` directory copied under ``tmp_path``,
    ``_build.SOURCES`` pointing at the copies."""
    sources = {}
    for name, src in _build.SOURCES.items():
        dst_dir = tmp_path / src.parent.parent.name / "csrc"
        if not dst_dir.exists():
            shutil.copytree(src.parent, dst_dir)
        sources[name] = dst_dir / src.name
    monkeypatch.setattr(_build, "SOURCES", sources)
    return sources


def _paths():
    return {name: _build.library_path(name) for name in _build.SOURCES}


@pytest.mark.parametrize("name", SSD_LIBS)
def test_editing_the_shared_header_changes_the_library_path(copied, name):
    header = copied[name].parent / "ssd_scan_mma.cuh"
    assert header.resolve() in _build.quoted_includes(copied[name])
    before = _paths()
    header.write_text(header.read_text() + "\n// edited\n")
    after = _paths()
    for lib in SSD_LIBS:   # both SSD libraries include the header
        assert after[lib] != before[lib], lib
    assert after["gmsa_score"] == before["gmsa_score"]


@pytest.mark.parametrize("name", tuple(_build.SOURCES))
def test_editing_the_source_changes_only_its_library_path(copied, name):
    before = _paths()
    copied[name].write_text(copied[name].read_text() + "\n// edited\n")
    after = _paths()
    for lib in _build.SOURCES:
        assert (after[lib] != before[lib]) == (lib == name), lib


def test_editing_an_unrelated_file_keeps_the_library_paths(copied):
    before = _paths()
    csrc = copied["ssd_scan"].parent
    unrelated = csrc / "notes.cuh"   # beside the sources, included by none
    unrelated.write_text("// not included\n")
    unrelated.write_text("// not included, edited\n")
    (csrc.parent / "kernel.py").write_text("# a file outside csrc\n")
    assert _paths() == before


def test_a_missing_quoted_include_raises(copied):
    src = copied["gmsa_score"]
    src.write_text('#include "no_such_header.cuh"\n' + src.read_text())
    with pytest.raises(FileNotFoundError, match="no_such_header"):
        _build.library_path("gmsa_score")


@pytest.mark.parametrize("name", tuple(_build.SOURCES))
def test_every_quoted_include_of_the_real_sources_resolves(name):
    """Read independently of ``quoted_includes``: each ``#include "…"`` of
    a source (and of the headers it includes) names a file beside it, and
    ``quoted_includes`` lists exactly those."""
    src = _build.SOURCES[name]
    seen, todo = [], [src]
    while todo:
        cur = todo.pop(0)
        for inc in re.findall(r'^\s*#\s*include\s*"([^"]+)"', cur.read_text(), re.M):
            path = (cur.parent / inc).resolve()
            assert path.is_file(), (cur, inc)
            if path not in seen:
                seen.append(path)
                todo.append(path)
    assert _build.quoted_includes(src) == seen
    if name in SSD_LIBS:
        assert [p.name for p in seen] == ["ssd_scan_mma.cuh"]
