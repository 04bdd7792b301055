"""ctypes bindings for the port's native host core.

The port's own copy of the reference's C++17 core (``src/``, ``include/``,
the same C ABI names and transform codes 0-4) is compiled by the host C++
compiler at first use (:mod:`fourier_tpu_torch.ffi.build`, no CMake) and
loaded here: :class:`NativeFftPlan` has the plan-then-execute surface of the
port's plans, over numpy arrays and torch CPU tensors.
:func:`fourier_tpu_torch.ffi.op.native_fft` makes the same core a
registered operator that traced torch programs can call.

Host only: the core runs on the CPU, as the reference's does (it has no
device path), so this is the one entry point of the port that does not
default to the card. A tensor on any other device is refused, never copied
to the host.
"""

from __future__ import annotations

import ctypes
import operator
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from fourier_tpu_torch.ffi import build

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

_SUFFIX = {np.dtype(np.complex64): "float", np.dtype(np.complex128): "double"}
_TORCH = {np.dtype(np.complex64): torch.complex64, np.dtype(np.complex128): torch.complex128}
_FROM_TORCH = {t: d for d, t in _TORCH.items()}


def build_library(force: bool = False) -> Path:
    """Build the native library with the host C++ compiler; returns its
    path. The file lock is taken before its existence is tested."""
    return build.build_library(force)


def load_library(build_if_missing: bool = True) -> ctypes.CDLL:
    """Load (building if needed) the native library and declare signatures."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = build.build_library() if build_if_missing else build.library_path()
        if not so.exists():
            raise FileNotFoundError(f"{so} not built; run build_library()")
        lib = ctypes.CDLL(str(so))
        for suffix in _SUFFIX.values():
            sigs = {
                "create": (ctypes.c_void_p, [ctypes.c_size_t]),
                "destroy": (None, [ctypes.c_void_p]),
                "transform_in_place": (None, [ctypes.c_void_p, ctypes.c_void_p,
                                              ctypes.c_int]),
                "transform": (None, [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int]),
                "size": (ctypes.c_size_t, [ctypes.c_void_p]),
                "transform_batch": (None, [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_size_t, ctypes.c_int]),
            }
            for name, (restype, argtypes) in sigs.items():
                fn = getattr(lib, f"fourier_{name}_{suffix}")
                fn.restype = restype
                fn.argtypes = argtypes
        _lib = lib
        return lib


def transform_code(transform) -> int:
    """The ABI code of a :class:`~fourier_tpu_torch.Transform` or an int;
    the C ABI ignores a code outside 0-4, so it is refused here."""
    code = int(getattr(transform, "value", transform))
    if not 0 <= code <= 4:
        raise ValueError(f"transform code {code} outside [0, 4]")
    return code


def _host_tensor(x: torch.Tensor) -> None:
    if x.device.type != "cpu":
        raise TypeError(f"the native core runs on the host: need a CPU tensor, got one "
                        f"on {x.device} (it is not copied to the host)")


class NativeFftPlan:
    """RAII wrapper over the C ABI, mirroring the port's plan surface.

    ``dtype`` is complex64 or complex128, numpy's or torch's. Every method
    takes numpy arrays or torch CPU tensors; a tensor in gives a tensor
    out. A plan owns scratch: one plan must not run on two threads at once.
    """

    def __init__(self, size: int, dtype=np.complex64):
        self.dtype = (_FROM_TORCH.get(dtype) if isinstance(dtype, torch.dtype)
                      else np.dtype(dtype))
        if self.dtype not in _SUFFIX:
            raise ValueError(f"unsupported dtype {dtype}")
        self._suffix = _SUFFIX[self.dtype]
        self.torch_dtype = _TORCH[self.dtype]
        size = operator.index(size)
        self._lib = load_library()
        self._handle = self._fn("create")(size) if size > 0 else None
        if not self._handle:
            raise ValueError(f"native plan creation failed for size {size}")
        self.size = size

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._fn("destroy")(handle)
            self._handle = None

    def _fn(self, name: str):
        return getattr(self._lib, f"fourier_{name}_{self._suffix}")

    def _buffer(self, x, shape_ok, what: str):
        """The pointer of `x`, a contiguous buffer of the plan's dtype that the
        core may write: TypeError for a wrong kind or dtype, ValueError for a
        wrong shape or layout."""
        if isinstance(x, torch.Tensor):
            _host_tensor(x)
            if x.dtype != self.torch_dtype:
                raise TypeError(f"need a {self.torch_dtype} tensor")
            if (not shape_ok(tuple(x.shape)) or not x.is_contiguous() or x.is_conj()
                    or x.is_neg()):
                raise ValueError(f"need a contiguous {what} tensor, got {tuple(x.shape)}")
            return ctypes.c_void_p(x.data_ptr())
        if not isinstance(x, np.ndarray) or x.dtype != self.dtype:
            raise TypeError(f"need a {self.dtype} ndarray")
        if not shape_ok(x.shape) or not x.flags.c_contiguous:
            raise ValueError(f"need a contiguous {what} array, got {x.shape}")
        return x.ctypes.data_as(ctypes.c_void_p)

    def transform(self, x, transform=0):
        """Out-of-place transform of a 1-D complex array or CPU tensor."""
        code = transform_code(transform)
        if isinstance(x, torch.Tensor):
            _host_tensor(x)
            x = x.detach().resolve_conj().resolve_neg().to(self.torch_dtype).contiguous()
            out = torch.empty_like(x)
            src, dst = ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr())
        else:
            x = np.ascontiguousarray(x, dtype=self.dtype)
            out = np.empty_like(x)
            src, dst = (a.ctypes.data_as(ctypes.c_void_p) for a in (x, out))
        if tuple(x.shape) != (self.size,):
            raise ValueError(f"expected shape ({self.size},), got {tuple(x.shape)}")
        self._fn("transform")(self._handle, src, dst, code)
        return out

    def transform_in_place(self, x, transform=0) -> None:
        """In-place transform of a contiguous 1-D complex array or tensor."""
        code = transform_code(transform)
        ptr = self._buffer(x, lambda s: s == (self.size,), "plan-size")
        self._fn("transform_in_place")(self._handle, ptr, code)

    def transform_batch_in_place(self, x, transform=0) -> None:
        """In-place transform of every row of a contiguous (batch, n) array.

        One FFI crossing for the whole batch (the C core loops the rows), so
        per-call overhead doesn't pollute batched-regime measurements.
        """
        code = transform_code(transform)
        ptr = self._buffer(x, lambda s: len(s) == 2 and s[1] == self.size,
                           f"(batch, {self.size})")
        self._fn("transform_batch")(self._handle, ptr, x.shape[0], code)

    def fft(self, x):
        return self.transform(x, 0)

    def ifft(self, x):
        return self.transform(x, 1)
