"""Discrete cosine / sine transforms (types I-IV) via the FFT plans.

Port of ``fourier_tpu/dctdst.py``: ``dct/idct/dst/idst`` with scipy.fft
semantics (types 1-4, norms backward / ortho / forward, any axis, batched
over the other axes) and their N-D forms ``dctn/idctn/dstn/idstn``.

Every transform reduces to one real FFT or one unscaled c2c IFFT through the
port's plans, with O(n) pre/post twiddles:

* DCT-I:  Re FFT[x, x[1:-1] reversed]           (length 2n-2)
* DCT-II: Re( e^{-i pi k/2n} . RFFT[x, rev x] ) (length 2n, Makhoul)
* DCT-III: inverse of the DCT-II factorization: spectrum rebuilt as
  V[k] = e^{i pi k/2n}(y[k] - i y[n-k]), one unscaled c2c IFFT of length n,
  even/odd de-interleave
* DCT-IV: odd-sample embedding in a length-8n RFFT
* DST-I:  -Im FFT[0, x, 0, -rev x]              (length 2n+2)
* DST-II: -Im( e^{-i pi k/2n} . RFFT[x, -rev x] )
* DST-III = diag((-1)^k) . DCT-III . flip ; DST-IV likewise from DCT-IV

Each axis runs on the batch-minor layout: the axis is brought to the front
of a contiguous (n, B) plane (a copy unless it leads in memory already) and
the real FFT runs ``RfftPlan.rfft_planar_bm`` (kernels B4/B5 in complex64 on
a CUDA device), the c2c IFFT ``transform_planar_bm``. The twiddles and the
ortho scalings are f64 numpy, cast to the real dtype once and cached per
(n, dtype, device). float32 input runs complex64 plans, float64 complex128
ones (native f64). A numpy input runs on ``device`` ("cuda" by default)
and comes back as numpy; a tensor runs on its own device.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from fourier_tpu_torch.ndim import (_as_tensor, _crop_pad_axis, _memory_order,
                                    _resolve_axes, _restore, _to_front)
from fourier_tpu_torch.plan.planner import create_fft
from fourier_tpu_torch.rfft import _rfft_plan
from fourier_tpu_torch.transform import Transform

_TABLES: OrderedDict = OrderedDict()
_TABLES_MAX = 256


def _table(name: str, n: int, like: torch.Tensor, make):
    """The (n, 1) column `make()` (f64 numpy) in `like`'s dtype and device,
    cached per (name, n, dtype, device)."""
    key = (name, n, str(like.dtype), str(like.device))
    if key in _TABLES:
        _TABLES.move_to_end(key)
        return _TABLES[key]
    col = torch.as_tensor(np.asarray(make(), np.float64).reshape(-1, 1),
                          device=like.device).to(like.dtype)
    _TABLES[key] = col
    while len(_TABLES) > _TABLES_MAX:
        _TABLES.popitem(last=False)
    return col


def _quarter_wave(n: int, like, start: int):
    """(cos, sin) of pi k / 2n, k = start..start+n-1, as columns."""
    theta = lambda: np.pi * np.arange(start, start + n) / (2.0 * n)
    return (_table(f"cos{start}", n, like, lambda: np.cos(theta())),
            _table(f"sin{start}", n, like, lambda: np.sin(theta())))


# The one FFT each type reduces to over an axis of n: a real FFT ("rfft")
# or an unscaled c2c IFFT ("c2c"), and its length. DST-III and DST-IV run
# DCT-III and DCT-IV on the flipped axis.
_REDUCTION = {
    ("dct", 1): ("rfft", lambda n: 2 * n - 2),
    ("dct", 2): ("rfft", lambda n: 2 * n),
    ("dct", 3): ("c2c", lambda n: n),
    ("dct", 4): ("rfft", lambda n: 8 * n),
    ("dst", 1): ("rfft", lambda n: 2 * n + 2),
    ("dst", 2): ("rfft", lambda n: 2 * n),
}
_REDUCTION[("dst", 3)] = _REDUCTION[("dct", 3)]
_REDUCTION[("dst", 4)] = _REDUCTION[("dct", 4)]


def reduction_plan(kind: str, type: int, n: int, dtype, device):
    """The cached 1-D plan that a `kind` ("dct" or "dst") of `type` over an
    axis of n runs: an ``RfftPlan`` or a c2c plan, in complex `dtype`."""
    via, length = _REDUCTION[(kind, type)]
    if via == "rfft":
        return _rfft_plan(length(n), dtype, device)
    return create_fft(length(n), dtype, device=device)


def _plan(kind: str, type: int, x: torch.Tensor):
    """`x`'s reduction plan: complex128 for float64 columns, else complex64."""
    dtype = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    return reduction_plan(kind, type, x.shape[0], dtype, x.device)


# -- backward-normalized kernels (axis 0 of (n, B) planes) -------------------


def _dct1(x):
    n = x.shape[0]
    if n < 2:
        raise ValueError("DCT-I requires n >= 2")
    re, _ = _plan("dct", 1, x).rfft_planar_bm(torch.cat([x, x[1:-1].flip(0)]))
    return re[:n]


def _dct2(x):
    n = x.shape[0]
    re, im = _plan("dct", 2, x).rfft_planar_bm(torch.cat([x, x.flip(0)]))
    c, s = _quarter_wave(n, x, 0)
    return c * re[:n] + s * im[:n]


def _dct3(y):
    n = y.shape[0]
    if n == 1:
        return y.clone()
    b = torch.cat([torch.zeros_like(y[:1]), y[1:].flip(0)])  # y[n-k], y[n] = 0
    c, s = _quarter_wave(n, y, 0)
    vr, _ = _plan("dct", 3, y).transform_planar_bm(
        c * y + s * b, s * y - c * b, Transform.UNSCALED_IFFT)
    half = (n + 1) // 2
    out = torch.empty_like(y)
    out[0::2] = vr[:half]
    out[1::2] = vr[half:].flip(0)
    return out


def _dct4(x):
    n = x.shape[0]
    plan = _plan("dct", 4, x)
    u = x.new_zeros((plan.n, *x.shape[1:]))
    u[1:2 * n:2] = x
    re, _ = plan.rfft_planar_bm(u)
    return 2.0 * re[1:2 * n:2]


def _dst1(x):
    z = torch.zeros_like(x[:1])
    _, im = _plan("dst", 1, x).rfft_planar_bm(torch.cat([z, x, z, -x.flip(0)]))
    return -im[1:x.shape[0] + 1]


def _dst2(x):
    n = x.shape[0]
    re, im = _plan("dst", 2, x).rfft_planar_bm(torch.cat([x, -x.flip(0)]))
    c, s = _quarter_wave(n, x, 1)
    return s * re[1:n + 1] - c * im[1:n + 1]


def _sign_alt(n: int, like):
    return _table("sign", n, like, lambda: (-1.0) ** np.arange(n))


def _dst3(x):
    return _sign_alt(x.shape[0], x) * _dct3(x.flip(0))


def _dst4(x):
    return _sign_alt(x.shape[0], x) * _dct4(x.flip(0))


_DCT = {1: _dct1, 2: _dct2, 3: _dct3, 4: _dct4}
_DST = {1: _dst1, 2: _dst2, 3: _dst3, 4: _dst4}
_INVERSE_TYPE = {1: 1, 2: 3, 3: 2, 4: 4}


def _den(kind: str, type: int, n: int) -> float:
    """Backward-normalization denominator: idct = dct(inv type) / den."""
    if type == 1:
        return 2.0 * (n - 1) if kind == "dct" else 2.0 * (n + 1)
    return 2.0 * n


def _ortho_pre_post(kind: str, type: int, n: int):
    """(pre, post) diagonal scalings turning backward into ortho norm."""
    pre = np.ones(n)
    post = np.ones(n)
    if kind == "dct":
        if type == 1:
            pre[0] = pre[-1] = np.sqrt(2.0)
            post[:] = np.sqrt(1.0 / (2.0 * (n - 1)))
            post[0] /= np.sqrt(2.0)
            post[-1] /= np.sqrt(2.0)
        elif type == 2:
            post[:] = np.sqrt(1.0 / (2.0 * n))
            post[0] = np.sqrt(1.0 / (4.0 * n))
        elif type == 3:
            pre[0] = 1.0 / np.sqrt(n)
            pre[1:] = 1.0 / np.sqrt(2.0 * n)
        else:
            post[:] = np.sqrt(1.0 / (2.0 * n))
    else:
        if type == 1:
            post[:] = np.sqrt(1.0 / (2.0 * (n + 1)))
        elif type == 2:
            post[:] = np.sqrt(1.0 / (2.0 * n))
            post[-1] = np.sqrt(1.0 / (4.0 * n))
        elif type == 3:
            pre[-1] = 1.0 / np.sqrt(n)
            pre[:-1] = 1.0 / np.sqrt(2.0 * n)
        else:
            post[:] = np.sqrt(1.0 / (2.0 * n))
    return pre, post


def _apply(kind: str, x: torch.Tensor, type: int, norm: str, inverse: bool):
    """The transform of the columns of a contiguous real (n, B) plane."""
    n = x.shape[0]
    if n == 0:
        raise ValueError("empty transform axis")
    eff_type = _INVERSE_TYPE[type] if inverse else type
    run = (_DCT if kind == "dct" else _DST)[eff_type]
    if norm == "ortho":
        pre_post = lambda: _ortho_pre_post(kind, eff_type, n)
        pre = _table(f"{kind}{eff_type}pre", n, x, lambda: pre_post()[0])
        post = _table(f"{kind}{eff_type}post", n, x, lambda: pre_post()[1])
        return run(x * pre) * post
    out = run(x)
    # 'backward': the inverse carries 1/den; 'forward': the forward does.
    if inverse == (norm == "backward"):
        out = out / _den(kind, eff_type, n)
    return out


def _transform(kind: str, x, type: int, s, axes, norm: Optional[str],
               inverse: bool, device, nd: bool):
    if type not in (1, 2, 3, 4):
        raise ValueError(f"type must be 1..4, got {type}")
    if norm not in (None, "backward", "ortho", "forward"):
        raise ValueError(f"norm must be backward/ortho/forward, got {norm!r}")
    xt, as_numpy = _as_tensor(x, device)
    if xt.is_complex():
        raise TypeError(f"{kind} is defined for real input, got {xt.dtype}")
    if xt.ndim == 0:
        raise ValueError(f"{kind}{'n' if nd else ''} requires at least one axis")
    xt = xt.to(torch.float64 if xt.dtype == torch.float64 else torch.float32)
    axes = (_resolve_axes(xt.ndim, s, axes, None) if nd
            else [_axis(axes, xt.ndim)])
    if s is not None:
        for a, n in zip(axes, s):
            xt = _crop_pad_axis(xt, int(n), a)
    planes, dims = _memory_order((xt,))
    for a in axes:
        (t,), dims = _to_front(planes, dims, a)
        out = _apply(kind, t.reshape(t.shape[0], -1), type, norm or "backward",
                     inverse)
        planes = (out.reshape(t.shape),)
    (out,) = _restore(planes, dims)
    return out.detach().cpu().numpy() if as_numpy else out


def _axis(axis: int, ndim: int) -> int:
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} is out of bounds for rank-{ndim} input")
    return axis % ndim


def dct(x, type: int = 2, norm: Optional[str] = None, axis: int = -1,
        device="cuda"):
    """DCT of types 1-4 (scipy.fft.dct semantics)."""
    return _transform("dct", x, type, None, axis, norm, False, device, False)


def idct(x, type: int = 2, norm: Optional[str] = None, axis: int = -1,
         device="cuda"):
    """Inverse DCT (scipy.fft.idct semantics)."""
    return _transform("dct", x, type, None, axis, norm, True, device, False)


def dst(x, type: int = 2, norm: Optional[str] = None, axis: int = -1,
        device="cuda"):
    """DST of types 1-4 (scipy.fft.dst semantics)."""
    return _transform("dst", x, type, None, axis, norm, False, device, False)


def idst(x, type: int = 2, norm: Optional[str] = None, axis: int = -1,
         device="cuda"):
    """Inverse DST (scipy.fft.idst semantics)."""
    return _transform("dst", x, type, None, axis, norm, True, device, False)


def dctn(x, type: int = 2, s=None, axes=None, norm: Optional[str] = None,
         device="cuda"):
    """N-D DCT over ``axes`` (scipy.fft.dctn semantics: separable 1-D DCTs,
    ``s`` pads/truncates)."""
    return _transform("dct", x, type, s, axes, norm, False, device, True)


def idctn(x, type: int = 2, s=None, axes=None, norm: Optional[str] = None,
          device="cuda"):
    """N-D inverse DCT (scipy.fft.idctn semantics)."""
    return _transform("dct", x, type, s, axes, norm, True, device, True)


def dstn(x, type: int = 2, s=None, axes=None, norm: Optional[str] = None,
         device="cuda"):
    """N-D DST over ``axes`` (scipy.fft.dstn semantics)."""
    return _transform("dst", x, type, s, axes, norm, False, device, True)


def idstn(x, type: int = 2, s=None, axes=None, norm: Optional[str] = None,
          device="cuda"):
    """N-D inverse DST (scipy.fft.idstn semantics)."""
    return _transform("dst", x, type, s, axes, norm, True, device, True)
