"""The exchange layer's copy primitive: planes copied between two strided
views of one shape (``csrc/strided_copy.cu``, its own library).

The sharded plans' ``gather`` and ``assemble`` (``parallel/exchange.py``)
copy permuted views that transpose the source's innermost dim against the
destination's. :func:`copy_layout` reduces such a copy to what the kernel
takes: the dims of extent 1 dropped, the others ordered by the
destination's strides (its innermost last), neighbours merged where both
sides allow it, and the source's innermost dim (``sdim``); the copy is
``tiled`` where that is not the destination's innermost dim.

:func:`strided_copy_reference` is the plain PyTorch version
(``dst.copy_(src)`` a plane), :func:`strided_copy` the wrapper: the plain
version for tensors on the CPU; for tensors on a CUDA device one launch of
the registered operator ``fourier_tpu_torch::strided_copy`` a layout (the
planes of a piece share one), or an error.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import Tensor

from fourier_tpu_torch.ops.cuda import build

MAX_DIMS = 6
MAX_PLANES = 4
# 4- and 8-byte elements, moved as bits: the f32 planes of c64 and of the
# double-word limbs, the f64 planes of c128.
DTYPES = (torch.float32, torch.float64)

LIBRARY = "strided_copy"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
ENTRY_POINTS = {
    "fourier_strided_copy": [_I, ctypes.POINTER(_P), ctypes.POINTER(_P), _I, _I, _L, _L, _L,
                             _I, _I, _P],
}
OP = "fourier_tpu_torch::strided_copy"


class CopyLayout(NamedTuple):
    """A copy as the kernel takes it: extents and element strides (source,
    destination) of each dim, ordered by the destination's strides, and
    the source's innermost dim."""

    size: Tuple[int, ...]
    src_stride: Tuple[int, ...]
    dst_stride: Tuple[int, ...]
    sdim: int

    @property
    def tiled(self) -> bool:
        """Whether the two sides' innermost dims differ (the tiled body)."""
        return self.sdim != len(self.size) - 1


def copy_layout(dst: Tensor, src: Tensor) -> Optional[CopyLayout]:
    """The layout of ``dst.copy_(src)`` for equal shapes; None where there
    is nothing to copy. Raises where the destination overlaps itself or
    the copy keeps more than ``MAX_DIMS`` dims."""
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"a copy takes equal shapes, got {tuple(dst.shape)} and "
                         f"{tuple(src.shape)}")
    if dst.numel() == 0:
        return None
    dims = sorted(((n, s, d) for n, s, d in zip(dst.shape, src.stride(), dst.stride())
                   if n != 1), key=lambda t: -t[2])
    if len({d for _, _, d in dims}) != len(dims) or any(d == 0 for _, _, d in dims):
        raise ValueError(f"the destination's strides {tuple(dst.stride())} overlap")
    merged = []
    for n, s, d in dims or [(1, 1, 1)]:
        if merged and merged[-1][1] == s * n and merged[-1][2] == d * n:
            merged[-1] = (merged[-1][0] * n, s, d)
        else:
            merged.append((n, s, d))
    if len(merged) > MAX_DIMS:
        raise ValueError(f"a copy of {len(merged)} dims that do not merge; the kernel "
                         f"takes {MAX_DIMS}")
    size, sstride, dstride = (tuple(v) for v in zip(*merged))
    sdim = min(range(len(size)), key=lambda k: (sstride[k], -k))
    return CopyLayout(size, sstride, dstride, sdim)


def strided_copy_reference(dst: Sequence[Tensor], src: Sequence[Tensor]) -> None:
    """Plain PyTorch: each plane of `src` into the same plane of `dst`."""
    for d, s in zip(dst, src):
        d.copy_(s)


def _check(dst: Sequence[Tensor], src: Sequence[Tensor]) -> None:
    if not 1 <= len(dst) <= MAX_PLANES or len(src) != len(dst):
        raise ValueError(f"a copy takes 1 to {MAX_PLANES} planes a side, equally many, got "
                         f"{len(dst)} and {len(src)}")
    first = dst[0]
    for t in (*dst, *src):
        if t.dtype not in DTYPES or t.dtype != first.dtype:
            raise TypeError(f"a copy takes planes of one dtype among {DTYPES}, got "
                            f"{t.dtype} beside {first.dtype}")
        if t.device != first.device:
            raise ValueError(f"a copy takes planes on one device, got {t.device} beside "
                             f"{first.device}")


def strided_copy(dst: Sequence[Tensor], src: Sequence[Tensor]) -> List[CopyLayout]:
    """Copy each plane of `src` into the same plane of `dst` (1 to
    ``MAX_PLANES`` planes of one dtype, float32 or float64, on one device;
    each with its destination's shape); the layouts copied, one a launch
    on a card: one where the planes share their shape and strides, as a
    piece's do, none for an empty copy.

    CPU tensors take the plain version. CUDA tensors take the kernel
    through the operator ``fourier_tpu_torch::strided_copy``, one launch a
    layout, counted in ``launches.fourier_tpu_torch::strided_copy``."""
    dst, src = list(dst), list(src)
    _check(dst, src)
    groups = {}
    for d, s in zip(dst, src):
        layout = copy_layout(d, s)
        if layout is not None:
            planes = groups.setdefault(layout, ([], []))
            planes[0].append(d)
            planes[1].append(s)
    if dst[0].device.type == "cpu":
        strided_copy_reference(dst, src)
    else:
        for layout, (d, s) in groups.items():
            _strided_copy_op(d, s, list(layout.size), list(layout.src_stride),
                             list(layout.dst_stride), layout.sdim)
    return list(groups)


def library():
    """Build (at first use) and load the copy's library."""
    return build.bind(LIBRARY, ENTRY_POINTS)


def _longs(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*values)


@torch.library.custom_op(OP, mutates_args=("dst",), device_types="cuda")
def _strided_copy_op(dst: List[Tensor], src: List[Tensor], size: List[int],
                     src_stride: List[int], dst_stride: List[int], sdim: int) -> None:
    """The copy's launch (see :func:`strided_copy`): the planes of `src`
    into those of `dst`, all laid out as (`size`, `src_stride`,
    `dst_stride`, `sdim`) of :func:`copy_layout`, from each tensor's
    data pointer."""
    t = dst[0]
    srcs = (ctypes.c_void_p * len(src))(*(s.data_ptr() for s in src))
    dsts = (ctypes.c_void_p * len(dst))(*(d.data_ptr() for d in dst))
    build.launch(
        OP, library(), "fourier_strided_copy",
        f"strided copy of {len(dst)} planes {tuple(t.shape)} {t.dtype}",
        len(dst), srcs, dsts, len(size), sdim, _longs(size), _longs(src_stride),
        _longs(dst_stride), t.element_size(), t.device.index,
        torch.cuda.current_stream(t.device).cuda_stream,
    )


@_strided_copy_op.register_fake
def _(dst, src, size, src_stride, dst_stride, sdim):
    return None
