"""scipy.fft backend: run existing scipy code on the port unchanged.

Port of ``fourier_tpu/scipy_backend.py``. ``scipy.fft`` dispatches every
public transform through `uarray` multimethods, so a third-party backend
can take over without callers changing a line. This module implements that
protocol (``__ua_domain__`` / ``__ua_function__``) over the port's surface,
on the backend object's ``device``:

    import scipy.fft
    import fourier_tpu_torch as ftt
    from fourier_tpu_torch.scipy_backend import FourierTpuScipyBackend

    with scipy.fft.set_backend(ftt.scipy_fft_backend):   # on the card
        X = scipy.fft.fft(x)

    with scipy.fft.set_backend(FourierTpuScipyBackend(device="cpu")):
        X = scipy.fft.fft(x)

Every adapter accepts the exact scipy signature. ``overwrite_x``,
``workers`` and ``plan`` are accepted and ignored, as scipy documents that
backends may do. Calls whose options the port's surface does not cover
(e.g. ``rfftn`` over non-trailing axes, ``dct`` with an ``orthogonalize``
other than its norm's) return ``NotImplemented``, so uarray falls through to
the next registered backend (scipy's own pocketfft by default): the same
calls as the JAX package's backend. Results are writable host arrays that
share no memory with the arguments (scipy.signal.istft writes into them).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import fourier_tpu_torch as ft


class _Fallback(Exception):
    """Adapter cannot honor these options; let the next backend handle it."""


def _trailing_ndim(axes, nd: int) -> Optional[int]:
    """axes == the last-k axes (any order)? -> k; else None."""
    if axes is None:
        return None
    axes = tuple(int(a) for a in (axes if np.iterable(axes) else (axes,)))
    k = len(axes)
    want = {nd - k + i for i in range(k)}
    got = {a % nd for a in axes}
    return k if got == want else None


def _crop_pad(x, n: Optional[int], axis: int):
    if n is None:
        return x
    x = np.asarray(x)
    n = int(n)
    cur = x.shape[axis]
    if n == cur:
        return x
    sl = [slice(None)] * x.ndim
    if n < cur:
        sl[axis] = slice(0, n)
        return x[tuple(sl)]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n - cur)
    return np.pad(x, pad)


def _check_ortho(norm, orthogonalize):
    """scipy's orthogonalize defaults to (norm == "ortho"); the port's
    transforms implement exactly that pairing."""
    if orthogonalize is not None and bool(orthogonalize) != (norm == "ortho"):
        raise _Fallback


def _adapters(dev):
    """{scipy.fft function name: adapter running the port on `dev`}."""

    def fft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None,
            *, plan=None):
        return ft.fft(x, n=n, norm=norm, axis=axis, device=dev)

    def ifft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None,
             *, plan=None):
        return ft.ifft(x, n=n, norm=norm, axis=axis, device=dev)

    def fft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False,
             workers=None, *, plan=None):
        return ft.fft2(x, s=s, axes=axes, norm=norm, device=dev)

    def ifft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False,
              workers=None, *, plan=None):
        return ft.ifft2(x, s=s, axes=axes, norm=norm, device=dev)

    def fftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None,
             *, plan=None):
        return ft.fftn(x, s=s, axes=axes, norm=norm, device=dev)

    def ifftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None,
              *, plan=None):
        return ft.ifftn(x, s=s, axes=axes, norm=norm, device=dev)

    def rfft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None,
             *, plan=None):
        return ft.rfft(x, n=n, norm=norm, axis=axis, device=dev)

    def irfft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None,
              *, plan=None):
        return ft.irfft(x, n=n, norm=norm, axis=axis, device=dev)

    def hfft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None,
             *, plan=None):
        return ft.hfft(x, n=n, norm=norm, axis=axis, device=dev)

    def ihfft(x, n=None, axis=-1, norm=None, overwrite_x=False, workers=None,
              *, plan=None):
        # ft.ihfft has no n: scipy's n crops/pads the real input first.
        return ft.ihfft(_crop_pad(x, n, axis), norm=norm, axis=axis, device=dev)

    def rfftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None,
              *, plan=None):
        if s is not None:
            raise _Fallback  # shape-adjusting N-D rfft not covered
        ndim = _trailing_ndim(axes, np.ndim(x))
        if axes is not None and ndim is None:
            raise _Fallback  # non-trailing axes
        return ft.rfftn(x, ndim=ndim, norm=norm, device=dev)

    def irfftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None,
               *, plan=None):
        ndim = _trailing_ndim(axes, np.ndim(x))
        if axes is not None and ndim is None:
            raise _Fallback
        return ft.irfftn(x, shape=s, ndim=ndim, norm=norm, device=dev)

    def hfftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None,
              *, plan=None):
        ndim = _trailing_ndim(axes, np.ndim(x))
        if axes is not None and ndim is None:
            raise _Fallback
        return ft.hfftn(x, shape=s, ndim=ndim, norm=norm, device=dev)

    def ihfftn(x, s=None, axes=None, norm=None, overwrite_x=False, workers=None,
               *, plan=None):
        if s is not None:
            raise _Fallback
        ndim = _trailing_ndim(axes, np.ndim(x))
        if axes is not None and ndim is None:
            raise _Fallback
        return ft.ihfftn(x, ndim=ndim, norm=norm, device=dev)

    def rfft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False,
              workers=None, *, plan=None):
        return rfftn(x, s=s, axes=axes, norm=norm)

    def irfft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False,
               workers=None, *, plan=None):
        return irfftn(x, s=s, axes=axes, norm=norm)

    def hfft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False,
              workers=None, *, plan=None):
        return hfftn(x, s=s, axes=axes, norm=norm)

    def ihfft2(x, s=None, axes=(-2, -1), norm=None, overwrite_x=False,
               workers=None, *, plan=None):
        return ihfftn(x, s=s, axes=axes, norm=norm)

    def dct1(fn):
        def adapter(x, type=2, n=None, axis=-1, norm=None, overwrite_x=False,
                    workers=None, orthogonalize=None):
            _check_ortho(norm, orthogonalize)
            return fn(_crop_pad(x, n, axis), type=type, norm=norm, axis=axis,
                      device=dev)

        return adapter

    def dctn(fn):
        def adapter(x, type=2, s=None, axes=None, norm=None, overwrite_x=False,
                    workers=None, orthogonalize=None):
            _check_ortho(norm, orthogonalize)
            return fn(x, type=type, s=s, axes=axes, norm=norm, device=dev)

        return adapter

    def fht(a, dln, mu, offset=0.0, bias=0.0):
        return ft.fht(a, dln, mu, offset=offset, bias=bias, device=dev)

    def ifht(A, dln, mu, offset=0.0, bias=0.0):
        return ft.ifht(A, dln, mu, offset=offset, bias=bias, device=dev)

    # (scipy's next_fast_len/prev_fast_len are lru_cache'd plain functions,
    # not uarray multimethods: they cannot dispatch to a backend.)
    table = {f.__name__: f for f in (
        fft, ifft, fft2, ifft2, fftn, ifftn, rfft, irfft, rfft2, irfft2, rfftn,
        irfftn, hfft, ihfft, hfft2, ihfft2, hfftn, ihfftn, fht, ifht)}
    for name in ("dct", "idct", "dst", "idst"):
        table[name] = dct1(getattr(ft, name))
        table[name + "n"] = dctn(getattr(ft, name + "n"))
    return table


class FourierTpuScipyBackend:
    """uarray backend object for the ``numpy.scipy.fft`` domain, running the
    port on ``device`` ("cuda", the card, by default)."""

    __ua_domain__ = "numpy.scipy.fft"

    def __init__(self, device="cuda"):
        self.device = device
        self._impl = _adapters(device)

    def __ua_function__(self, method, args, kwargs):
        impl = self._impl.get(getattr(method, "__name__", None))
        if impl is None:
            return NotImplemented
        try:
            out = impl(*args, **kwargs)
        except _Fallback:
            return NotImplemented
        # scipy callers mutate results in place (e.g. scipy.signal.istft's
        # `xsubs *= win.sum()`): hand back a writable array that aliases no
        # argument (on the CPU a result can be a view of the input).
        out = np.asarray(out)
        if not out.flags.writeable or any(
                isinstance(a, np.ndarray) and np.may_share_memory(out, a)
                for a in (*args, *kwargs.values())):
            out = out.copy()
        return out

    def __repr__(self) -> str:
        return f"FourierTpuScipyBackend(device={self.device!r})"


scipy_fft_backend = FourierTpuScipyBackend("cuda")
