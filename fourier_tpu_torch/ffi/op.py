"""The native host core as a registered operator.

:func:`native_fft` is ``fourier_tpu_torch::native_fft``, a
``torch.library.custom_op`` on the CPU over the C ABI's
``fourier_transform_batch_{float,double}``: the native core reachable from
traced torch programs (``torch.compile(fullgraph=True)``, ``torch.export``,
``torch.func.vmap``), as the reference's XLA custom call makes it reachable
from jitted JAX programs. Its fake gives the output's shape and dtype; its
vmap rule moves the mapped dim to the front, where it is one more batch
axis. Plans are cached by (n, dtype) behind a lock that also covers their
execution, because a plan owns scratch.

Host only, as in the reference: the operator has no CUDA kernel, so the
dispatcher refuses a CUDA tensor, and :func:`native_fft` refuses any tensor
not on the CPU.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from fourier_tpu_torch.ffi import NativeFftPlan, _host_tensor, transform_code

_plans: dict = {}
_plans_lock = threading.Lock()


def _check(x: torch.Tensor, code: int) -> None:
    """The reference's refusals (``xla.py``, ``xla_ffi.cpp:run_batch``)."""
    if x.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"native_fft requires complex input, got {x.dtype}")
    transform_code(code)
    if x.dim() < 1:
        raise ValueError("native_fft needs rank >= 1 (the last axis is transformed)")
    if x.shape[-1] == 0:
        raise ValueError("native_fft: transform length must be >= 1")


@torch.library.custom_op("fourier_tpu_torch::native_fft", mutates_args=(),
                         device_types="cpu")
def _native_fft_op(x: torch.Tensor, code: int) -> torch.Tensor:
    _check(x, code)
    n = x.shape[-1]
    out = x.resolve_conj().resolve_neg().clone(memory_format=torch.contiguous_format)
    with _plans_lock:
        plan = _plans.get((n, x.dtype))
        if plan is None:
            plan = _plans[(n, x.dtype)] = NativeFftPlan(n, x.dtype)
        plan.transform_batch_in_place(out.view(-1, n), code)
    return out


@_native_fft_op.register_fake
def _(x, code):
    _check(x, code)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _vmap(info, in_dims, x, code):
    x_dim, _ = in_dims
    if x_dim is not None:
        x = x.movedim(x_dim, 0)
    return _native_fft_op(x, code), 0 if x_dim is not None else None


torch.library.register_vmap("fourier_tpu_torch::native_fft", _vmap)


def native_fft(x, transform) -> torch.Tensor:
    """FFT of ``x`` along the last axis, computed by the native C++ core.

    ``x``: a complex64/complex128 numpy array or CPU tensor of rank >= 1
    (leading axes are batch). ``transform``: a
    :class:`~fourier_tpu_torch.Transform` or its ABI code 0-4. Returns a
    CPU tensor. Matches ``NativeFftPlan.transform`` row by row.
    """
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    _host_tensor(x)
    return _native_fft_op(x, transform_code(transform))
