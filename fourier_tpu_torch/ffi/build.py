"""Build the native host core of ``fourier_tpu_torch/ffi`` without CMake.

The shared library (``src/fft_core.cpp`` + ``src/capi.cpp``, the C ABI) and
the ``dump_plan`` tool (``tools/dump_plan.cpp`` + ``src/fft_core.cpp``) are
compiled by the host C++ compiler (``$CXX``, else ``c++``, else ``g++``)
with the flags of the reference's CMake Release build, into
``build/fourier_tpu_torch/ffi/`` at the repository root, each named by a
hash of the flags and of every C/C++ source under ``ffi/``. The lock, the
hash and the rename are those of the CUDA kernels' build
(``utils/native_build.py``). A missing compiler or a failed compile raises
``RuntimeError`` with the compiler's output; nothing falls back. Each build
is a ``lib.build`` span of ``fourier_tpu_torch.trace``.
``CMakeLists.txt`` beside it builds the same sources for C and C++
consumers and runs their ctest suite.
"""

from __future__ import annotations

import os
import shlex
import shutil
import subprocess
from pathlib import Path

from fourier_tpu_torch.utils.native_build import BUILD_ROOT, build_locked, source_hash

FFI_DIR = Path(__file__).resolve().parent
BUILD_DIR = BUILD_ROOT / "ffi"

CXX_FLAGS = ("-std=c++17", "-O3", "-DNDEBUG", "-Wall", "-Wextra", "-fPIC")
SOURCE_SUFFIXES = (".cpp", ".hpp", ".h", ".c")
LIBRARY_SOURCES = ("src/fft_core.cpp", "src/capi.cpp")
DUMP_PLAN_SOURCES = ("tools/dump_plan.cpp", "src/fft_core.cpp")


def compiler() -> list:
    """The host C++ compiler's command: $CXX, else c++, else g++."""
    if os.environ.get("CXX"):
        return shlex.split(os.environ["CXX"])
    for name in ("c++", "g++"):
        if shutil.which(name):
            return [name]
    raise RuntimeError("no host C++ compiler: set CXX or put c++ or g++ on PATH")


def _key() -> str:
    return source_hash(CXX_FLAGS, FFI_DIR, SOURCE_SUFFIXES)


def library_path() -> Path:
    return BUILD_DIR / f"libfourier_tpu-{_key()}.so"


def dump_plan_path() -> Path:
    return BUILD_DIR / f"dump_plan-{_key()}"


def _build(target: Path, what: str, sources, extra, force: bool) -> Path:
    def compile_to(tmp):
        cmd = [*compiler(), *CXX_FLAGS, *extra, "-o", str(tmp),
               *(str(FFI_DIR / s) for s in sources)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the host C++ compiler {cmd[0]!r}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")

    build_locked(target, BUILD_DIR / f"{what}.lock", compile_to, force)
    return target


def build_library(force: bool = False) -> Path:
    """The native core's shared library (built if missing, or if `force`)."""
    return _build(library_path(), "library", LIBRARY_SOURCES, ("-shared",), force)


def build_dump_plan(force: bool = False) -> Path:
    """The ``dump_plan`` executable (built if missing, or if `force`)."""
    return _build(dump_plan_path(), "dump_plan", DUMP_PLAN_SOURCES, (), force)
