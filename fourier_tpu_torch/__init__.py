"""fourier_tpu_torch: the PyTorch/CUDA port of fourier-tpu.

Plan-then-execute FFTs on torch tensors, held against the JAX package
``fourier_tpu`` (the reference). ``create_fft_f32`` / ``create_fft_f64``
build plans on ``device``, the card ("cuda") unless the caller asks for the
CPU; plans expose ``transform_planar``, ``transform_planar_bm``,
``transform``, ``fft`` and ``ifft``. On a CUDA device the default complex64
path runs the hand-written Hopper kernels of ``csrc/`` through
``ops/cuda/stockham_vpu.py``: B1 (fused Stockham), B2 (fused Bluestein) and
B3 (four-step row leg); the other complex64 sizes run DFT products
(``ops/bailey.py``) in full float32. complex128 runs the ``dd`` route in
native f64 (``precision/``, ``ops/cuda/stockham_vpu_dd.py``,
``ops/cuda/dd_combine.py``): B6 (fused Stockham), B7 (fused Bluestein) and
B8 (split combine over B6). Real transforms (``RfftPlan``, ``rfft``,
``irfft``, ``hfft``, ``ihfft``) run B4 (even n) and B5 (odd n) on their
batch-minor path in complex64, and the unfused pack around the c128 route.
A user-built ``MxuFftPlan.create(n, impl="pallas")`` runs B9a (n <= 128) or
B9b (a split n1*n2) of ``ops/cuda/bailey.py``; ``impl="xla_packed"`` runs
B9a for n <= 128. ``describe`` / ``summarize`` give a plan's structure and
cost model (``plan/summary.py``).

The numpy-compatible surface runs on the same 1-D plans: ``NdFftPlan`` and
``fftn`` / ``ifftn`` / ``fft2`` / ``ifft2`` (``ndim.py``), the N-D real and
Hermitian family ``rfftn`` ... ``ihfft2`` (``rfft.py``), DCT/DST of types
1-4 and their N-D forms (``dctdst.py``), the fast Hankel transform
(``fftlog.py``) and ``fftfreq`` / ``fftshift`` / ``ifftshift``
(``utils/helpers.py``). Signal pipelines and convolution layers run on the
same plans: FFT and overlap-add convolution, correlation, the analytic
signal, resampling, the chirp-z transform, ``CztPlan`` and ``ConvolvePlan``
(``signal.py``); the STFT, ``StftPlan`` and the Welch family
(``spectral.py``); and ``scipy_fft_backend`` runs scipy.fft calls, and the
scipy.signal code above them, on the port (``scipy_backend.py``).

Plans save and load without planning (``save_plan``, ``load_plan``,
``plan_to_bytes``; ``plan/serialize.py``), plan by measurement on the card
with wisdom (``measure_fft``, ``create_fft(backend="measure")``,
``export_wisdom``, ``import_wisdom``; ``plan/measure.py``) and export ahead
of time (``export_compiled``, ``load_compiled``, ``CompiledFft``;
``plan/aot.py``, ``torch.export`` over the kernels as registered
operators). ``tools/bench_suite.py`` times the suite's rows beside
``torch.fft``; ``tools/prof.py`` runs a plan in a loop for the profiler.

The sharded plans, ``fourier_tpu_torch.parallel`` (``FourStepPlan``,
``Fft2dPlan``, ``Fft3dPlan``, ``Rfft2dPlan``, ``Rfft3dPlan``,
``batched_transform``, ``batched_rfft``, ``batched_irfft``), run the same
1-D plans on every rank of a ``torch.distributed`` DeviceMesh, exchanging
through ``all_to_all_single`` (NCCL between cards).

The native host core, ``fourier_tpu_torch.ffi`` (``NativeFftPlan`` over the
C ABI of its C++ sources, and ``ffi.op.native_fft``, a registered CPU
operator), runs on the host only; it is imported on demand, and its library
is compiled by the host C++ compiler at first use.

``fourier_tpu_torch.trace`` records what a call did at each layer
boundary: spans (in a running ``torch.profiler``'s timeline, and set-up
events always), and one registry of counts (calls, launches by operator,
plan cache hits and misses, libraries loaded and built, exchange legs and
bytes).

This package imports torch and never jax.
"""

from __future__ import annotations

import numpy as _np
import torch as _torch

from fourier_tpu_torch import trace
from fourier_tpu_torch.plan import (
    AutosortPlan,
    BluesteinPlan,
    CompiledFft,
    DdFftPlan,
    DdMxuDirectPlan,
    DdSplitPow2Plan,
    DdSplitRadixPlan,
    FftPlan,
    FourStepLocalPlan,
    MxuFftPlan,
    VpuBluesteinPlan,
    VpuDdBluesteinPlan,
    VpuDdFftPlan,
    VpuFftPlan,
    clear_plan_cache,
    create_fft,
    create_fft_f32,
    create_fft_f64,
    export_compiled,
    export_wisdom,
    forget_wisdom,
    import_wisdom,
    load_compiled,
    load_jax_plan,
    load_plan,
    measure_fft,
    plan_to_bytes,
    save_plan,
)
from fourier_tpu_torch.plan.summary import PlanSummary, describe, summarize
from fourier_tpu_torch.ndim import (NdFftPlan, _as_tensor, _crop_pad_axis,
                                    _norm_mode, fft2, fftn, ifft2, ifftn)
from fourier_tpu_torch.dctdst import (dct, dctn, dst, dstn, idct, idctn, idst,
                                      idstn)
from fourier_tpu_torch.rfft import (RfftPlan, hfft, hfft2, hfftn, ihfft,
                                    ihfft2, ihfftn, irfft, irfft2, irfftn,
                                    rfft, rfft2, rfftfreq, rfftn)
from fourier_tpu_torch.fftlog import fht, fhtoffset, ifht
from fourier_tpu_torch.utils.helpers import fftfreq, fftshift, ifftshift
from fourier_tpu_torch.signal import (ConvolvePlan, CztPlan, correlate,
                                      correlation_lags, czt, fftconvolve,
                                      hilbert, hilbert2, next_fast_len,
                                      oaconvolve, prev_fast_len, resample,
                                      zoom_fft)
from fourier_tpu_torch.spectral import (StftPlan, check_cola, check_nola,
                                        coherence, csd, istft, periodogram,
                                        spectrogram, stft, welch)
from fourier_tpu_torch.transform import Transform

__version__ = "0.1.0"


def transform(x, mode: Transform, dtype=None, device="cuda"):
    """Plan-and-run a transform over the last axis of a complex array.

    `x` is a numpy array (planned on `device`, numpy out) or a torch tensor
    (planned on its own device, tensor out). A float64 input plans
    complex128.
    """
    xt = x if isinstance(x, _torch.Tensor) else _torch.as_tensor(_np.asarray(x))
    if dtype is None:
        if xt.dtype in (_torch.complex64, _torch.complex128):
            dtype = xt.dtype
        elif xt.dtype == _torch.float64:
            dtype = _torch.complex128
        else:
            dtype = _torch.complex64
    plan_device = xt.device if isinstance(x, _torch.Tensor) else device
    return create_fft(xt.shape[-1], dtype, device=plan_device).transform(x, mode)


def _fft_1d(x, n, norm, dtype, forward: bool, axis: int, device):
    xt, as_numpy = _as_tensor(x, device)
    xt = _torch.movedim(xt, axis, -1)
    if n is not None:
        xt = _crop_pad_axis(xt, int(n), xt.ndim - 1)
    mode, fwd_scale = _norm_mode(norm, forward)
    out = transform(xt, mode, dtype)
    if fwd_scale:
        out = out / xt.shape[-1]
    out = _torch.movedim(out, -1, axis)
    return out.detach().cpu().numpy() if as_numpy else out


def fft(x, n=None, norm=None, dtype=None, axis: int = -1, device="cuda"):
    """Forward FFT over ``axis`` (numpy.fft.fft compatibility: ``n`` crops or
    zero-pads, ``norm`` is backward/ortho/forward). A numpy `x` runs on
    ``device``, a tensor on its own device."""
    return _fft_1d(x, n, norm, dtype, True, axis, device)


def ifft(x, n=None, norm=None, dtype=None, axis: int = -1, device="cuda"):
    """Inverse FFT over ``axis`` (numpy.fft.ifft compatibility)."""
    return _fft_1d(x, n, norm, dtype, False, axis, device)


import contextlib as _contextlib

_workers = 1


@_contextlib.contextmanager
def set_workers(workers: int):
    """scipy.fft.set_workers-compatible context manager, accepted for API
    compatibility: host-thread worker counts do not apply, the card runs
    the batch in parallel."""
    global _workers
    prev, _workers = _workers, int(workers)
    try:
        yield
    finally:
        _workers = prev


def get_workers() -> int:
    """scipy.fft.get_workers-compatible accessor (see :func:`set_workers`)."""
    return _workers


def transform_planar(re, im, mode: Transform, dtype=None, device="cuda"):
    """Planar plan-and-run over the last axis through the cached
    ``create_fft`` (complex64 unless `dtype`). Tensor planes run on their
    own device (tensors out); numpy planes run on ``device`` (numpy out)."""
    re, as_numpy = _as_tensor(re, device)
    im, _ = _as_tensor(im, re.device)
    if dtype is None:
        dtype = _torch.complex64
    ore, oim = create_fft(re.shape[-1], dtype, device=re.device).transform_planar(
        re, im, mode)
    if as_numpy:
        return ore.detach().cpu().numpy(), oim.detach().cpu().numpy()
    return ore, oim


def fft_planar(re, im, dtype=None, device="cuda"):
    return transform_planar(re, im, Transform.FFT, dtype, device)


def ifft_planar(re, im, dtype=None, device="cuda"):
    return transform_planar(re, im, Transform.IFFT, dtype, device)


__all__ = [
    "AutosortPlan",
    "BluesteinPlan",
    "CompiledFft",
    "ConvolvePlan",
    "CztPlan",
    "DdFftPlan",
    "DdMxuDirectPlan",
    "DdSplitPow2Plan",
    "DdSplitRadixPlan",
    "FftPlan",
    "FourStepLocalPlan",
    "MxuFftPlan",
    "PlanSummary",
    "RfftPlan",
    "StftPlan",
    "Transform",
    "VpuBluesteinPlan",
    "VpuDdBluesteinPlan",
    "VpuDdFftPlan",
    "VpuFftPlan",
    "clear_plan_cache",
    "create_fft",
    "create_fft_f32",
    "create_fft_f64",
    "NdFftPlan",
    "check_cola",
    "check_nola",
    "coherence",
    "correlate",
    "correlation_lags",
    "csd",
    "czt",
    "dct",
    "dctn",
    "describe",
    "dst",
    "dstn",
    "export_compiled",
    "export_wisdom",
    "fft",
    "fft2",
    "fft_planar",
    "fftconvolve",
    "fftfreq",
    "fftn",
    "fftshift",
    "fht",
    "fhtoffset",
    "forget_wisdom",
    "get_workers",
    "hfft",
    "hfft2",
    "hfftn",
    "hilbert",
    "hilbert2",
    "idct",
    "idctn",
    "idst",
    "idstn",
    "ifft",
    "ifft2",
    "ifft_planar",
    "ifftn",
    "ifftshift",
    "ifht",
    "ihfft",
    "ihfft2",
    "ihfftn",
    "import_wisdom",
    "irfft",
    "irfft2",
    "irfftn",
    "istft",
    "load_compiled",
    "load_jax_plan",
    "load_plan",
    "measure_fft",
    "next_fast_len",
    "oaconvolve",
    "periodogram",
    "plan_to_bytes",
    "prev_fast_len",
    "resample",
    "rfft",
    "rfft2",
    "rfftfreq",
    "rfftn",
    "save_plan",
    "scipy_fft_backend",
    "set_workers",
    "spectrogram",
    "stft",
    "summarize",
    "transform",
    "transform_planar",
    "welch",
    "zoom_fft",
    "__version__",
]


def __getattr__(name):
    # Lazy: scipy_backend imports this package back (its adapters run the
    # public surface), so it must not load during package init.
    if name == "scipy_fft_backend":
        from fourier_tpu_torch.scipy_backend import scipy_fft_backend

        return scipy_fft_backend
    # The sharded plans (fourier_tpu_torch.parallel, as fourier_tpu.parallel)
    # load torch.distributed.tensor: on first use only.
    if name == "parallel":
        import importlib

        return importlib.import_module("fourier_tpu_torch.parallel")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
