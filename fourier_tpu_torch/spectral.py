"""Short-time Fourier analysis and the Welch family (scipy.signal semantics).

Port of ``fourier_tpu/spectral.py``: ``stft``, ``istft``, ``check_nola``,
``check_cola``, ``welch``, ``csd``, ``periodogram``, ``coherence``,
``spectrogram`` and :class:`StftPlan`.

Framing, boundary extension, padding, detrending, windowing, the spectral
products, the segment averages and the overlap-add all run as torch ops on
the input's device. The frames are laid out batch-minor, (nfft, *batch,
nframes) contiguous, so one batched transform runs them all: the one-sided
spectra on ``RfftPlan.rfft_planar_bm`` / ``irfft_planar_bm`` (kernels B4 and
B5 on the card), the two-sided ones on the c2c plan's
``transform_planar_bm``. The spectra are handed back in scipy's layout
(..., freq, time) as permuted views. The inverses overlap-add with the
shifted-copy fold of :func:`fourier_tpu_torch.signal._fold`: ceil(nperseg /
hop) strided adds, deterministic, in place of the reference's per-frame
loops (``istft``) and scatter-add (``StftPlan.istft_planar``).

Detrending runs in f64 (complex128 for complex input), as the reference
does, so a large DC offset does not cancel in f32; a callable ``detrend``
receives the frames as a tensor (..., nframes, nperseg) of that dtype on
the input's device and returns one of the same shape. Windows come from
``scipy.signal.get_window`` in f64 at call or plan time and are moved to
the device once, cast.

complex128 runs in native f64 on the card, the one-sided ``StftPlan``
included (its c128 ``RfftPlan`` runs the unfused pack around the ``dd``
route's inner plan).

Every entry point runs on the card unless the caller asks for the CPU: a
numpy input is copied to ``device`` ("cuda" by default) once and back once,
a tensor input runs on its own device and gives tensors; ``f`` and ``t``
are numpy.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fourier_tpu_torch.ndim import _as_tensor
from fourier_tpu_torch.plan.base import complex_dtype, resolve_device
from fourier_tpu_torch.plan.planner import create_fft
from fourier_tpu_torch.rfft import RfftPlan, _rfft_plan
from fourier_tpu_torch.signal import _default_cdtype, _fold, _out, _pair, _real_of
from fourier_tpu_torch.transform import Transform

__all__ = ["stft", "istft", "check_nola", "check_cola", "periodogram",
           "welch", "csd", "coherence", "spectrogram", "StftPlan"]


def _get_window(window, nperseg: int) -> np.ndarray:
    """Resolve a scipy-style window spec to an f64 array of length nperseg."""
    if isinstance(window, (str, tuple)):
        from scipy.signal import get_window

        return np.asarray(get_window(window, nperseg), np.float64)
    if isinstance(window, torch.Tensor):
        window = window.detach().cpu().numpy()
    win = np.asarray(window, np.float64)
    if win.ndim != 1:
        raise ValueError("window must be 1-D")
    if win.shape[0] != nperseg:
        raise ValueError(
            f"window length {win.shape[0]} != nperseg {nperseg}"
        )
    return win


def _column(values, like: torch.Tensor, dtype) -> torch.Tensor:
    """f64 numpy `values` on `like`'s device as `dtype`, shaped to broadcast
    along the leading axis of `like`."""
    t = torch.as_tensor(values, device=like.device).to(dtype)
    return t.reshape(-1, *[1] * (like.ndim - 1))


def _detrend_frames(frames: torch.Tensor, detrend) -> torch.Tensor:
    """Detrend f64 (or complex128) frames laid out (nperseg, ...)."""
    if callable(detrend):
        return detrend(frames.movedim(0, -1)).movedim(-1, 0)
    if detrend == "constant":
        return frames - frames.mean(0, keepdim=True)
    if detrend == "linear":
        n = frames.shape[0]
        t = np.arange(n, dtype=np.float64)
        t = _column(t - t.mean(), frames, torch.float64)
        mean = frames.mean(0, keepdim=True)
        slope = ((frames - mean) * t).sum(0, keepdim=True) / (t * t).sum()
        return frames - mean - slope * t
    raise ValueError(f"detrend must be False/'constant'/'linear'/callable, "
                     f"got {detrend!r}")


def _frame_planes(x: torch.Tensor, nperseg: int, nstep: int, nfft: int,
                  win: np.ndarray, detrend, rt: torch.dtype):
    """(re, im) planes (nfft, *batch, nframes) of `rt`, contiguous: the
    nframes = 1 + (n - nperseg) // nstep frames of `x` (..., n), detrended
    in f64, times `win` (f64, any scale folded in), zero-padded to nfft;
    im is None for real `x`."""
    frames = x.unfold(-1, nperseg, nstep).movedim(-1, 0)
    if detrend:
        wide = torch.complex128 if x.is_complex() else torch.float64
        frames = _detrend_frames(frames.to(wide), detrend)
    w = _column(win, frames, frames.real.dtype if detrend else rt)
    parts = (frames.real, frames.imag) if frames.is_complex() else (frames, None)
    planes = []
    for p in parts:
        if p is None:
            planes.append(None)
            continue
        plane = p.new_empty((nfft, *p.shape[1:]), dtype=rt)
        plane[nperseg:] = 0
        if p.dtype == rt:  # the windowed frames written once, in place
            torch.mul(p, w, out=plane[:nperseg])
        else:
            plane[:nperseg] = p * w
        planes.append(plane)
    return planes


def _spectra(planes, nfft: int, onesided: bool, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batched transform of the frame planes (nfft, *batch, nframes):
    the one-sided or the full spectra, (bins, *batch, nframes)."""
    re, im = planes
    rest = re.shape[1:]
    if onesided:
        plan = _rfft_plan(nfft, dtype, re.device)
        zr, zi = plan.rfft_planar_bm(re.reshape(nfft, -1))
    else:
        im = torch.zeros_like(re) if im is None else im
        plan = create_fft(nfft, dtype, device=re.device)
        zr, zi = plan.transform_planar_bm(re.reshape(nfft, -1),
                                          im.reshape(nfft, -1), Transform.FFT)
    return zr.reshape(-1, *rest), zi.reshape(-1, *rest)


def _extend_boundary(x: torch.Tensor, kind: Optional[str],
                     ext: int) -> torch.Tensor:
    """scipy.signal._arraytools-style boundary extension along the last axis."""
    if kind is None or ext == 0:
        return x
    if kind == "zeros":
        return F.pad(x, (ext, ext))
    # Reflect about the edge sample WITHOUT repeating it (scipy's
    # even_ext/odd_ext): left mirror is x[ext..1], right is x[-2..-ext-1].
    head = x[..., 1:ext + 1].flip(-1)
    tail = x[..., -(ext + 1):-1].flip(-1)
    if kind == "even":
        return torch.cat([head, x, tail], dim=-1)
    if kind == "odd":
        return torch.cat([2 * x[..., :1] - head, x, 2 * x[..., -1:] - tail], dim=-1)
    if kind == "constant":
        return torch.cat([x[..., :1].expand(*x.shape[:-1], ext), x,
                          x[..., -1:].expand(*x.shape[:-1], ext)], dim=-1)
    raise ValueError(
        f"boundary must be None/'zeros'/'even'/'odd'/'constant', got {kind!r}"
    )


def _resolve_seg(n: int, nperseg: Optional[int], noverlap: Optional[int],
                 nfft: Optional[int]) -> Tuple[int, int, int]:
    nperseg = 256 if nperseg is None else int(nperseg)
    if nperseg < 1:
        raise ValueError("nperseg must be >= 1")
    if nperseg > n:
        warnings.warn(
            f"nperseg = {nperseg} is greater than input length = {n}, "
            f"using nperseg = {n}"
        )
        nperseg = n
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    nfft = nperseg if nfft is None else int(nfft)
    if nfft < nperseg:
        raise ValueError("nfft must be >= nperseg")
    return nperseg, noverlap, nfft


def _freqs(nfft: int, fs: float, onesided: bool) -> np.ndarray:
    if onesided:
        return np.arange(nfft // 2 + 1, dtype=np.float64) * (fs / nfft)
    return np.fft.fftfreq(nfft, 1.0 / fs)


def stft(x, fs: float = 1.0, window="hann", nperseg: Optional[int] = None,
         noverlap: Optional[int] = None, nfft: Optional[int] = None,
         detrend=False, return_onesided: bool = True,
         boundary: Optional[str] = "zeros", padded: bool = True,
         scaling: str = "spectrum", dtype=None, device="cuda"):
    """Short-time Fourier transform (scipy.signal.stft semantics).

    Returns ``(f, t, Zxx)`` with ``Zxx[..., freq, time]``. The transform runs
    as one batched rfft/fft with frames as the batch dimension. ``dtype``
    picks the transform family (complex128 for float64/complex128 input,
    else complex64).
    """
    xt, as_numpy = _as_tensor(x, device)
    if xt.numel() == 0:
        raise ValueError("x must be non-empty")
    n_in = xt.shape[-1]
    nperseg_req = 256 if nperseg is None else int(nperseg)
    nperseg, noverlap, nfft = _resolve_seg(n_in, nperseg_req, noverlap, nfft)
    nstep = nperseg - noverlap
    win = _get_window(window, nperseg)

    complex_in = xt.is_complex()
    onesided = return_onesided and not complex_in
    if return_onesided and complex_in:
        warnings.warn(
            "Input data is complex, switching to return_onesided=False"
        )
    dtype = _default_cdtype(xt, dtype)

    xt = _extend_boundary(xt, boundary, nperseg // 2)
    if padded:
        nadd = (-(xt.shape[-1] - nperseg) % nstep) % nperseg
        if nadd:
            xt = F.pad(xt, (0, nadd))

    if scaling == "spectrum":
        scale = 1.0 / win.sum()
    elif scaling == "psd":
        scale = 1.0 / np.sqrt(fs * (win * win).sum())
    else:
        raise ValueError(f"scaling must be 'spectrum' or 'psd', got "
                         f"{scaling!r}")

    planes = _frame_planes(xt, nperseg, nstep, nfft, win * scale, detrend,
                           _real_of(dtype))
    z = torch.complex(*_spectra(planes, nfft, onesided, dtype))
    t = (
        np.arange(nperseg / 2, xt.shape[-1] - nperseg / 2 + 1, nstep)
        / float(fs)
    )
    if boundary is not None:
        t -= (nperseg / 2) / float(fs)
    # (freq, *batch, time) -> (*batch, freq, time), scipy's Zxx layout
    return _freqs(nfft, fs, onesided), t, _out(z.movedim(0, -2), as_numpy)


# -- device-resident STFT plan ------------------------------------------------


class StftPlan(torch.nn.Module):
    """STFT plan with a fixed window and hop, resident on its device.

    ``stft_planar`` frames the signal, windows it and runs one batched
    transform (frames as batch columns); ``istft_planar`` inverts it by
    weighted overlap-add. Semantics match ``stft(x, boundary=None,
    padded=False)``: trailing samples that do not fill a full segment are
    dropped. ``onesided=True`` takes and returns real signal planes (the
    plan's ``RfftPlan``), ``onesided=False`` runs c2c on planar (re, im).
    Both directions are differentiable through the plans' linear rules. The
    windows are buffers (f64 at plan time, cast), the inner plan is the
    plan's own: ``.to()`` moves them all. complex128 runs on the card in
    native f64, one-sided too.
    """

    def __init__(self, nperseg: int, hop: Optional[int] = None,
                 window="hann", nfft: Optional[int] = None,
                 dtype=torch.complex64, onesided: bool = True,
                 scaling: Optional[str] = "spectrum", fs: float = 1.0,
                 device="cuda"):
        super().__init__()
        self.nperseg = int(nperseg)
        if self.nperseg < 1:
            raise ValueError("nperseg must be >= 1")
        self.hop = self.nperseg // 2 if hop is None else int(hop)
        if not 1 <= self.hop <= self.nperseg:
            raise ValueError("need 1 <= hop <= nperseg")
        self.nfft = self.nperseg if nfft is None else int(nfft)
        if self.nfft < self.nperseg:
            raise ValueError("nfft must be >= nperseg")
        self.onesided = bool(onesided)
        self.scaling = scaling
        self.fs = float(fs)
        self.dtype = complex_dtype(dtype)
        device = resolve_device(device)

        win = _get_window(window, self.nperseg)
        if scaling is None:
            scale = 1.0
        elif scaling == "spectrum":
            scale = 1.0 / win.sum()
        elif scaling == "psd":
            scale = 1.0 / np.sqrt(self.fs * (win * win).sum())
        else:
            raise ValueError(
                f"scaling must be None/'spectrum'/'psd', got {scaling!r}"
            )
        self.scale = float(scale)
        rt = _real_of(self.dtype)
        self.register_buffer("win", torch.as_tensor(win * scale, device=device).to(rt))
        # unscaled, for the weighted overlap-add
        self.register_buffer("win_inv", torch.as_tensor(win, device=device).to(rt))
        self.invertible = check_nola(win, self.nperseg, self.nperseg - self.hop)
        if self.onesided:
            self.inner = RfftPlan(self.nfft, self.dtype, device=device)
        else:
            self.inner = create_fft(self.nfft, self.dtype, device=device, cache=False)

    @property
    def device(self) -> torch.device:
        return self.win.device

    @property
    def real_dtype(self) -> torch.dtype:
        return _real_of(self.dtype)

    # -- geometry -------------------------------------------------------------

    @property
    def n_bins(self) -> int:
        return self.nfft // 2 + 1 if self.onesided else self.nfft

    def n_frames(self, n_samples: int) -> int:
        if n_samples < self.nperseg:
            raise ValueError(
                f"signal length {n_samples} < nperseg {self.nperseg}"
            )
        return 1 + (n_samples - self.nperseg) // self.hop

    def n_samples(self, n_frames: int) -> int:
        return (int(n_frames) - 1) * self.hop + self.nperseg

    def f(self) -> np.ndarray:
        return _freqs(self.nfft, self.fs, self.onesided)

    def t(self, n_samples: int) -> np.ndarray:
        k = self.n_frames(n_samples)
        return (self.nperseg / 2 + self.hop * np.arange(k)) / self.fs

    # -- execution -------------------------------------------------------------

    def _plane(self, p) -> torch.Tensor:
        """A plane as a tensor of the plan's real dtype on its device: numpy
        is copied there; a tensor on another device raises."""
        if not isinstance(p, torch.Tensor):
            p = torch.as_tensor(np.asarray(p), device=self.device)
        elif p.device != self.device:
            raise ValueError(f"input on {p.device} but plan on {self.device}; "
                             f"build the plan with device={str(p.device)!r}")
        return p.to(self.real_dtype)

    def _frames(self, p) -> torch.Tensor:
        """(..., n) -> windowed frames (nfft, *batch, n_frames), zero-padded."""
        p = self._plane(p)
        self.n_frames(p.shape[-1])
        frames = p.unfold(-1, self.nperseg, self.hop).movedim(-1, 0)
        frames = frames * self.win.reshape(-1, *[1] * (frames.ndim - 1))
        if self.nfft == self.nperseg:
            return frames
        out = frames.new_zeros((self.nfft, *frames.shape[1:]))
        out[:self.nperseg] = frames
        return out

    def stft_planar(self, x, im=None):
        """(..., n) plane(s) -> (..., n_frames, n_bins) spectrum planes.

        Real one-sided: ``stft_planar(x) -> (re, im)``. Two-sided planar:
        ``stft_planar(re, im) -> (re, im)``.
        """
        fr = self._frames(x)
        rest = fr.shape[1:]
        if self.onesided:
            if im is not None:
                raise ValueError("onesided plan takes a single real plane")
            zr, zi = self.inner.rfft_planar_bm(fr.reshape(self.nfft, -1))
        else:
            fim = torch.zeros_like(fr) if im is None else self._frames(im)
            zr, zi = self.inner.transform_planar_bm(
                fr.reshape(self.nfft, -1), fim.reshape(self.nfft, -1), Transform.FFT)
        return (zr.reshape(-1, *rest).movedim(0, -1),
                zi.reshape(-1, *rest).movedim(0, -1))

    def istft_planar(self, re, im):
        """(..., n_frames, n_bins) planes -> signal plane(s), WOLA inverse."""
        if not self.invertible:
            raise ValueError(
                "NOLA condition failed for this window/hop: not invertible"
            )
        re, im = self._plane(re).movedim(-1, 0), self._plane(im).movedim(-1, 0)
        rest, k = re.shape[1:], re.shape[-1]
        n = self.n_samples(k)
        bins = re.shape[0]
        if self.onesided:
            planes = (self.inner.irfft_planar_bm(re.reshape(bins, -1),
                                                 im.reshape(bins, -1)),)
        else:
            planes = self.inner.transform_planar_bm(
                re.reshape(bins, -1), im.reshape(bins, -1), Transform.IFFT)
        w = self.win_inv * (1.0 / self.scale)
        norm = _ola_norm(self.win_inv, self.hop, k, n)
        out = []
        for p in planes:
            p = p.reshape(self.nfft, *rest)[:self.nperseg]
            p = p * w.reshape(-1, *[1] * (p.ndim - 1))
            out.append(_fold(p, self.hop).narrow(-1, 0, n) / norm)
        return out[0] if self.onesided else tuple(out)

    def extra_repr(self) -> str:
        side = "onesided" if self.onesided else "twosided"
        return (f"nperseg={self.nperseg}, hop={self.hop}, nfft={self.nfft}, "
                f"{side}, dtype={self.dtype}")


def _ola_norm(win: torch.Tensor, nstep: int, nframes: int, n: int) -> torch.Tensor:
    """The overlap-add of win^2 over the frame positions, floored at 1 where
    it is not above 1e-10 (the weighted overlap-add's divisor), length n."""
    w2 = (win * win)[:, None].expand(-1, nframes)
    norm = _fold(w2, nstep).narrow(-1, 0, n)
    return torch.where(norm > 1e-10, norm, torch.ones_like(norm))


# -- power-spectral-density family (scipy.signal.welch etc.) -----------------


def _spect_frames(x: torch.Tensor, fs: float, window, nperseg: Optional[int],
                  noverlap: Optional[int], nfft: Optional[int], detrend,
                  onesided: bool, scaling: str, dtype):
    """Shared welch/spectrogram core: scaled spectra of the frames as planes
    (bins, *batch, time).

    Like scipy's _spectral_helper with boundary=None, padded=False: segments
    that do not fill a full nperseg are dropped. Returns (f, t, (re, im),
    onesided, nfft) where the spectra carry sqrt(scale), so any conj(X)*Y
    product carries exactly one power scale factor.
    """
    n = x.shape[-1]
    nperseg, noverlap, nfft = _resolve_seg(n, nperseg, noverlap, nfft)
    nstep = nperseg - noverlap
    win = _get_window(window, nperseg)

    onesided = onesided and not x.is_complex()
    dtype = _default_cdtype(x, dtype)

    if scaling == "density":
        scale = 1.0 / (fs * (win * win).sum())
    elif scaling == "spectrum":
        scale = 1.0 / win.sum() ** 2
    else:
        raise ValueError(f"scaling must be 'density' or 'spectrum', got "
                         f"{scaling!r}")

    planes = _frame_planes(x, nperseg, nstep, nfft, win * np.sqrt(scale),
                           detrend, _real_of(dtype))
    z = _spectra(planes, nfft, onesided, dtype)
    t = np.arange(nperseg / 2, n - nperseg / 2 + 1, nstep) / float(fs)
    return _freqs(nfft, fs, onesided), t, z, onesided, nfft


def _onesided_double(p: torch.Tensor, nfft: int) -> torch.Tensor:
    """Double the shared bins (leading axis) of a one-sided PSD: all but DC
    and, for even nfft, Nyquist."""
    stop = p.shape[0] - 1 if nfft % 2 == 0 else p.shape[0]
    p = p.clone()
    p[1:stop] *= 2.0
    return p


def _median_bias(n: int) -> float:
    """Bias of the median of n scaled chi^2(2) variables (scipy's)."""
    ii_2 = 2 * np.arange(1.0, (n - 1) // 2 + 1)
    return float(1 + np.sum(1.0 / (ii_2 + 1) - 1.0 / ii_2))


def _median(p: torch.Tensor) -> torch.Tensor:
    """np.median over the last axis: the mean of the two middle values for
    an even count (torch.median would give the lower one)."""
    k = p.shape[-1]
    mid = p.sort(-1).values.narrow(-1, (k - 1) // 2, 2 - k % 2)
    return mid.mean(-1)


def csd(x, y, fs: float = 1.0, window="hann", nperseg: Optional[int] = None,
        noverlap: Optional[int] = None, nfft: Optional[int] = None,
        detrend="constant", return_onesided: bool = True,
        scaling: str = "density", average: str = "mean", dtype=None,
        device="cuda"):
    """Cross power spectral density via Welch's method (scipy.signal.csd).

    Returns ``(f, Pxy)`` with ``Pxy = <conj(X) * Y>`` averaged over segments
    ('mean' or bias-corrected 'median'). Both signals' segment FFTs run as
    one batched transform each. The shorter input is zero-padded.
    """
    if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
        same = x is y
    else:
        xa, ya = np.asarray(x), np.asarray(y)
        same = xa is ya or (xa.shape == ya.shape and np.shares_memory(xa, ya))
    xt, yt, as_numpy = _pair(x, y, device)
    if not same and xt.shape[-1] != yt.shape[-1]:
        nmax = max(xt.shape[-1], yt.shape[-1])
        xt = F.pad(xt, (0, nmax - xt.shape[-1]))
        yt = F.pad(yt, (0, nmax - yt.shape[-1]))
    f, _, (xr, xi), onesided, nfft_r = _spect_frames(
        xt, fs, window, nperseg, noverlap, nfft, detrend,
        return_onesided and not yt.is_complex(), scaling, dtype,
    )
    if same:
        yr, yi = xr, xi
    else:
        _, _, (yr, yi), _, _ = _spect_frames(
            yt, fs, window, nperseg, noverlap, nfft, detrend, onesided,
            scaling, dtype,
        )
    # conj(X) * Y, planar, segments on the last axis
    pr, pi = xr * yr + xi * yi, xr * yi - xi * yr
    if onesided:
        pr, pi = _onesided_double(pr, nfft_r), _onesided_double(pi, nfft_r)
    nseg = pr.shape[-1]
    if average == "mean":
        pr, pi = pr.mean(-1), pi.mean(-1)
    elif average == "median":
        bias = _median_bias(nseg)
        pr, pi = _median(pr) / bias, _median(pi) / bias
    else:
        raise ValueError(f"average must be 'mean' or 'median', got "
                         f"{average!r}")
    return f, _out(torch.complex(pr, pi).movedim(0, -1), as_numpy)


def welch(x, fs: float = 1.0, window="hann", nperseg: Optional[int] = None,
          noverlap: Optional[int] = None, nfft: Optional[int] = None,
          detrend="constant", return_onesided: bool = True,
          scaling: str = "density", average: str = "mean", dtype=None,
          device="cuda"):
    """Power spectral density via Welch's method (scipy.signal.welch)."""
    f, pxx = csd(x, x, fs, window, nperseg, noverlap, nfft, detrend,
                 return_onesided, scaling, average, dtype, device)
    return f, pxx.real


def periodogram(x, fs: float = 1.0, window="boxcar",
                nfft: Optional[int] = None, detrend="constant",
                return_onesided: bool = True, scaling: str = "density",
                dtype=None, device="cuda"):
    """Single-segment PSD estimate (scipy.signal.periodogram)."""
    n = x.shape[-1] if isinstance(x, torch.Tensor) else np.shape(x)[-1]
    return welch(x, fs, window, nperseg=n, noverlap=0, nfft=nfft,
                 detrend=detrend, return_onesided=return_onesided,
                 scaling=scaling, dtype=dtype, device=device)


def coherence(x, y, fs: float = 1.0, window="hann",
              nperseg: Optional[int] = None, noverlap: Optional[int] = None,
              nfft: Optional[int] = None, detrend="constant", dtype=None,
              device="cuda"):
    """Magnitude-squared coherence |Pxy|^2/(Pxx*Pyy) (scipy.signal.coherence)."""
    f, pxx = welch(x, fs, window, nperseg, noverlap, nfft, detrend,
                   dtype=dtype, device=device)
    _, pyy = welch(y, fs, window, nperseg, noverlap, nfft, detrend,
                   dtype=dtype, device=device)
    _, pxy = csd(x, y, fs, window, nperseg, noverlap, nfft, detrend,
                 dtype=dtype, device=device)
    return f, abs(pxy) ** 2 / (pxx * pyy)


def _unwrap(p: torch.Tensor, dim: int) -> torch.Tensor:
    """np.unwrap along `dim` (discont = pi, period 2*pi)."""
    dd = torch.diff(p, dim=dim)
    ddmod = torch.remainder(dd + math.pi, 2 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0),
                        torch.full_like(ddmod, math.pi), ddmod)
    correct = torch.where(dd.abs() < math.pi, torch.zeros_like(dd), ddmod - dd)
    out = p.clone()
    out.narrow(dim, 1, p.shape[dim] - 1).add_(correct.cumsum(dim))
    return out


def spectrogram(x, fs: float = 1.0, window=("tukey", 0.25),
                nperseg: Optional[int] = None,
                noverlap: Optional[int] = None, nfft: Optional[int] = None,
                detrend="constant", return_onesided: bool = True,
                scaling: str = "density", mode: str = "psd", dtype=None,
                device="cuda"):
    """Per-segment spectrogram (scipy.signal.spectrogram semantics).

    ``mode`` is psd / complex / magnitude / angle / phase; default overlap is
    nperseg//8 (scipy's spectrogram default, unlike stft's 50%). Returns
    ``(f, t, Sxx)`` with ``Sxx[..., freq, time]``.
    """
    if mode not in ("psd", "complex", "magnitude", "angle", "phase"):
        raise ValueError(
            f"mode must be psd/complex/magnitude/angle/phase, got {mode!r}"
        )
    xt, as_numpy = _as_tensor(x, device)
    if noverlap is None:
        nperseg_r, _, _ = _resolve_seg(
            xt.shape[-1], 256 if nperseg is None else int(nperseg), 0, nfft
        )
        noverlap = nperseg_r // 8
    f, t, (zr, zi), onesided, nfft_r = _spect_frames(
        xt, fs, window, nperseg, noverlap, nfft, detrend, return_onesided,
        scaling, dtype,
    )
    if mode == "psd":
        sxx = zr * zr + zi * zi
        if onesided:
            sxx = _onesided_double(sxx, nfft_r)
    elif mode == "complex":
        sxx = torch.complex(zr, zi)
    elif mode == "magnitude":
        sxx = torch.hypot(zr, zi)
    else:
        sxx = torch.atan2(zi, zr)
        if mode == "phase":
            # scipy unwraps along the frequency axis (here the leading one)
            sxx = _unwrap(sxx, 0)
    return f, t, _out(sxx.movedim(0, -2), as_numpy)


def check_nola(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """Nonzero-overlap-add invertibility condition (scipy.signal.check_NOLA)."""
    nperseg, noverlap = int(nperseg), int(noverlap)
    if nperseg < 1 or not 0 <= noverlap < nperseg:
        raise ValueError("need nperseg >= 1 and 0 <= noverlap < nperseg")
    win = _get_window(window, nperseg)
    nstep = nperseg - noverlap
    binsums = np.zeros(nstep)
    w2 = win * win
    for off in range(0, nperseg, nstep):
        chunk = w2[off:off + nstep]
        binsums[:chunk.shape[0]] += chunk
    return bool(np.min(binsums) > tol * np.max(w2))


def check_cola(window, nperseg: int, noverlap: int, tol: float = 1e-10) -> bool:
    """Constant-overlap-add condition (scipy.signal.check_COLA)."""
    nperseg, noverlap = int(nperseg), int(noverlap)
    if nperseg < 1 or not 0 <= noverlap < nperseg:
        raise ValueError("need nperseg >= 1 and 0 <= noverlap < nperseg")
    win = _get_window(window, nperseg)
    nstep = nperseg - noverlap
    binsums = np.zeros(nstep)
    for off in range(0, nperseg, nstep):
        chunk = win[off:off + nstep]
        binsums[:chunk.shape[0]] += chunk
    return bool(np.max(np.abs(binsums - binsums.mean())) < tol * nperseg)


def istft(Zxx, fs: float = 1.0, window="hann", nperseg: Optional[int] = None,
          noverlap: Optional[int] = None, nfft: Optional[int] = None,
          input_onesided: bool = True, boundary: bool = True,
          scaling: str = "spectrum", dtype=None, device="cuda"):
    """Inverse STFT via weighted overlap-add (scipy.signal.istft semantics).

    ``Zxx[..., freq, time]`` as produced by :func:`stft`; returns ``(t, x)``.
    All inverse transforms run as one batched irfft/ifft (frames = batch);
    the windowed frames overlap-add in f64 (complex128 two-sided), the
    reference's output dtype.
    """
    zt, as_numpy = _as_tensor(Zxx, device)
    if zt.ndim < 2:
        raise ValueError("Zxx must have at least 2 dimensions (freq, time)")
    nbins, nframes = zt.shape[-2], zt.shape[-1]
    if nperseg is None:
        if nfft is not None:
            nperseg = int(nfft)
        else:
            nperseg = 2 * (nbins - 1) if input_onesided else nbins
    nperseg = int(nperseg)
    nfft = nperseg if nfft is None else int(nfft)
    if nfft < nperseg:
        raise ValueError("nfft must be >= nperseg")
    want_bins = nfft // 2 + 1 if input_onesided else nfft
    if nbins != want_bins:
        raise ValueError(
            f"frequency axis has {nbins} bins, expected {want_bins} for "
            f"nfft={nfft} ({'one' if input_onesided else 'two'}-sided)"
        )
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    if noverlap >= nperseg:
        raise ValueError("noverlap must be less than nperseg")
    nstep = nperseg - noverlap
    win = _get_window(window, nperseg)
    if not check_nola(win, nperseg, noverlap):
        raise ValueError(
            "NOLA condition failed: STFT not invertible with this "
            "window/noverlap"
        )

    if dtype is None:
        dtype = torch.complex128 if zt.dtype == torch.complex128 else torch.complex64
    dtype = complex_dtype(dtype)
    if scaling == "spectrum":
        unscale = win.sum()
    elif scaling == "psd":
        unscale = np.sqrt(fs * (win * win).sum())
    else:
        raise ValueError(f"scaling must be 'spectrum' or 'psd', got "
                         f"{scaling!r}")

    zc = zt.to(dtype).movedim(-2, 0)  # (freq, *batch, time)
    rest = zc.shape[1:]
    re = zc.real.reshape(nbins, -1)
    im = zc.imag.reshape(nbins, -1)
    if input_onesided:
        planes = (_rfft_plan(nfft, dtype, zt.device).irfft_planar_bm(re, im),)
    else:
        planes = create_fft(nfft, dtype, device=zt.device).transform_planar_bm(
            re, im, Transform.IFFT)
    w = torch.as_tensor(win * unscale, device=zt.device)
    n = (nframes - 1) * nstep + nperseg
    norm = _ola_norm(torch.as_tensor(win, device=zt.device), nstep, nframes, n)
    out = []
    for p in planes:
        p = p.reshape(nfft, *rest)[:nperseg].to(torch.float64)
        p = p * w.reshape(-1, *[1] * (p.ndim - 1))
        out.append(_fold(p, nstep).narrow(-1, 0, n) / norm)
    x = out[0] if input_onesided else torch.complex(*out)
    if boundary:
        ext = nperseg // 2
        x = x[..., ext:n - ext]
    t = np.arange(x.shape[-1]) / float(fs)
    return t, _out(x, as_numpy)
