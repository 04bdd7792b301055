"""The build key of the port's CUDA library (no nvcc needed).

The library under ``build/fourier_tpu_torch/`` is named by a hash of the
compiler flags and of every source under ``csrc/``: ``stockham_vpu.cu``
includes ``stockham_stages.cuh``, so an edit to the header must select a new
library instead of loading a stale one.
"""

import re
import shutil

import pytest

from fourier_tpu_torch.ops.cuda import build
from fourier_tpu_torch.ops.cuda.stockham_vpu import ENTRY_POINTS, LIBRARY


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    return csrc


def test_every_library_has_a_source():
    src = (build.CSRC / f"{LIBRARY}.cu").read_text()
    assert '#include "stockham_stages.cuh"' in src
    assert (build.CSRC / "stockham_stages.cuh").is_file()
    # Each entry point the wrapper binds is defined with as many parameters.
    for fn_name, argtypes in [*ENTRY_POINTS.items(), ("fourier_cuda_error_string", [int])]:
        m = re.search(rf"\b{fn_name}\(([^)]*)\)\s*{{", src)
        assert m is not None, fn_name
        assert len(m.group(1).split(",")) == len(argtypes), fn_name


def test_f64_library_has_its_entry_points():
    """The f64 library (B6-B8) includes the shared stage code and defines
    each entry point its wrapper binds with as many parameters."""
    from fourier_tpu_torch.ops.cuda import stockham_vpu_dd as dv

    src = (build.CSRC / f"{dv.LIBRARY}.cu").read_text()
    assert '#include "stockham_stages.cuh"' in src
    for fn_name, argtypes in [*dv.ENTRY_POINTS.items(),
                              ("fourier_cuda_error_string", [int])]:
        m = re.search(rf"\b{fn_name}\(([^)]*)\)\s*{{", src)
        assert m is not None, fn_name
        assert len(m.group(1).split(",")) == len(argtypes), fn_name
    assert build.library_path(dv.LIBRARY) != build.library_path(LIBRARY)


def test_load_all_builds_each_library_once(monkeypatch):
    """load_all hands every name to load, concurrently, in order."""
    seen = []
    monkeypatch.setattr(build, "load", lambda name: seen.append(name) or name)
    assert build.load_all(["a", "b"]) == ["a", "b"] and sorted(seen) == ["a", "b"]


@pytest.mark.parametrize("edited", ["stockham_stages.cuh", "stockham_vpu.cu",
                                    "new_header.h"])
def test_source_edit_changes_every_library_path(csrc_copy, edited):
    before = build.library_path(LIBRARY)
    path = csrc_copy / edited
    old = path.read_text() if path.exists() else ""
    path.write_text(old + "\n// edited\n")
    after = build.library_path(LIBRARY)
    assert after != before and after.parent == build.BUILD_DIR


def test_other_files_and_flags(csrc_copy, monkeypatch):
    before = build.library_path(LIBRARY)
    (csrc_copy / "notes.txt").write_text("not a source\n")
    assert build.library_path(LIBRARY) == before
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path(LIBRARY) != before
