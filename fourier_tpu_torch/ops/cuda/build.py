"""Build and load the hand-written CUDA kernels of ``fourier_tpu_torch/csrc``.

``csrc/<name>.cu`` exposes a plain C interface. On first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under
``build/fourier_tpu_torch/`` at the repository root, named by a hash of the
flags and of every source under ``csrc/`` (``*.cu``, ``*.cuh``, ``*.h``: it
includes headers), and loaded with ``ctypes``. A file lock is taken before
the library's existence is tested, so concurrent processes neither load a
half-written library nor build it twice; the compiler writes to a temporary
name that is renamed into place.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "fourier_tpu_torch"

# No --use_fast_math: it replaces sinf/cosf and flushes denormals.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

SOURCE_SUFFIXES = (".cu", ".cuh", ".h")

_loaded: dict = {}
_lock = threading.Lock()


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    sources = sorted(p for p in CSRC.rglob("*") if p.suffix in SOURCE_SUFFIXES)
    for src in sources:
        h.update(str(src.relative_to(CSRC)).encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed and return the loaded library."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        so = library_path(name)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"{name}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not so.exists():
                tmp = so.with_suffix(f".tmp{os.getpid()}")
                cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
                        f"{proc.stdout}\n{proc.stderr}"
                    )
                os.replace(tmp, so)
            _loaded[name] = ctypes.CDLL(str(so))
        return _loaded[name]
