"""Build and load the hand-written CUDA kernels of ``fourier_tpu_torch/csrc``.

``csrc/<name>.cu`` exposes a plain C interface. On first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under
``build/fourier_tpu_torch/`` at the repository root, named by a hash of the
flags and of every source under ``csrc/`` (``*.cu``, ``*.cuh``, ``*.h``: it
includes headers), and loaded with ``ctypes``. A file lock is taken before
the library's existence is tested, so concurrent processes neither load a
half-written library nor build it twice; the compiler writes to a temporary
name that is renamed into place (``utils/native_build.py``, shared with the
native host core's build). :func:`load_all` builds several libraries at
once, one ``nvcc`` each. A load is the lifecycle span ``lib.load`` and the
count ``lib.loads``, a build inside it ``lib.build`` (``fourier_tpu_torch.
trace``). :func:`launch` calls a registered operator's C entry point:
the span ``launch`` (``launch.first`` the first time in the process, where
the CUDA driver loads the kernel's module), and one ``launches.<operator>``
a launch. ptxas reports each function's registers and spills
(``-Xptxas -v``); the report is kept beside the library
(:func:`resource_usage`).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from fourier_tpu_torch import trace
from fourier_tpu_torch.utils.native_build import BUILD_ROOT, build_locked, source_hash

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = BUILD_ROOT

# No --use_fast_math: it replaces sinf/cosf and flushes denormals.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

SOURCE_SUFFIXES = (".cu", ".cuh", ".h")

_loaded: dict = {}
_launched: set = set()  # the (library, entry point) pairs launched once
_locks: dict = {}  # one per library, so that two libraries build at once
_guard = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        candidates.append(Path(shutil.which("nvcc")))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the build of csrc/<name>.cu goes, keyed by the flags and by the
    name and bytes of every source under csrc/."""
    return BUILD_DIR / f"lib{name}-{source_hash(NVCC_FLAGS, CSRC, SOURCE_SUFFIXES)}.so"


def load(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed and return the loaded library."""
    with _guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        with trace.span("lib.load", lib=name):
            so = library_path(name)

            def compile_to(tmp):
                cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
                        f"{proc.stdout}\n{proc.stderr}"
                    )
                so.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)

            build_locked(so, BUILD_DIR / f"{name}.lock", compile_to)
            _loaded[name] = ctypes.CDLL(str(so))
        trace.count("lib.loads")
        return _loaded[name]


def resource_usage(name: str) -> str:
    """ptxas's report (registers, spills, stack) of the library's build."""
    return library_path(name).with_suffix(".ptxas.txt").read_text()


def load_all(names) -> list:
    """Build (in parallel, one nvcc each) and load several libraries."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(load, names))


def bind(name: str, entry_points) -> ctypes.CDLL:
    """Load csrc/<name>.cu and set the argument types of its C entry points
    (`entry_points`: name -> ctypes argument types; each returns an int
    cudaError_t) and of its ``fourier_cuda_error_string``."""
    lib = load(name)
    if lib.fourier_cuda_error_string.restype is not ctypes.c_char_p:
        for fn_name, argtypes in entry_points.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.fourier_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fourier_cuda_error_string.restype = ctypes.c_char_p
    return lib


def call(lib: ctypes.CDLL, fn_name: str, what: str, *args) -> None:
    """Call the C entry point `fn_name` of `lib`; raise if it fails."""
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        msg = lib.fourier_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def launch(op: str, lib: ctypes.CDLL, fn_name: str, what: str, *args) -> None:
    """:func:`call` for a launch of the registered operator `op`
    (``fourier_tpu_torch::<name>``), counted in ``launches.<op>``."""
    key = (lib._name, fn_name)
    if key not in _launched:
        with trace.span("launch.first", op=op, entry=fn_name):
            call(lib, fn_name, what, *args)
        _launched.add(key)
    elif trace.profiling():
        with trace.span("launch", op=op):
            call(lib, fn_name, what, *args)
    else:
        call(lib, fn_name, what, *args)
    trace.count("launches." + op)
