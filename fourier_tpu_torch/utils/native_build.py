"""What the port's native builds share: the source hash that names a build
and the locked build into a temporary name.

The CUDA kernels (``ops/cuda/build.py``, nvcc) and the native host core
(``ffi/build.py``, the host C++ compiler) both build at first use into
``build/fourier_tpu_torch/`` at the repository root. A build is named by a
hash of its flags and of every source beside it, so an edit to any source
selects a new build instead of loading a stale one; the file lock is taken
before the build's existence is tested, so concurrent processes neither load
a half-written file nor build it twice; the compiler writes to a temporary
name that is renamed into place.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
from pathlib import Path
from typing import Callable, Sequence

# The repository's build directory for the port.
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "fourier_tpu_torch"


def source_hash(flags: Sequence[str], root: Path, suffixes: Sequence[str]) -> str:
    """16 hex digits of a hash of `flags` and of the name and bytes of every
    file under `root` whose suffix is in `suffixes`."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sorted(p for p in root.rglob("*") if p.suffix in suffixes):
        h.update(str(src.relative_to(root)).encode() + b"\0" + src.read_bytes())
    return h.hexdigest()[:16]


def build_locked(target: Path, lock: Path, compile_to: Callable[[Path], None],
                 force: bool = False) -> bool:
    """Under the file lock `lock`, build `target` unless it exists (or
    `force`): `compile_to(tmp)` writes a temporary file, which is renamed
    onto `target`. Returns whether this call built it; a failed compile
    leaves no temporary file."""
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(lock, "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if target.exists() and not force:
            return False
        tmp = target.with_name(f"{target.name}.tmp{os.getpid()}")
        try:
            compile_to(tmp)
            os.replace(tmp, target)
        finally:
            tmp.unlink(missing_ok=True)
        return True
