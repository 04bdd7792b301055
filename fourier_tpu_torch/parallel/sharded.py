"""Sharded FFTs over a ``torch.distributed`` DeviceMesh.

Port of ``fourier_tpu/parallel/sharded.py``: the JAX package's ``shard_map``
bodies run as the same per-rank steps on the local tensors of DTensors, and
its ``jax.lax.all_to_all`` over ICI is ``all_to_all_single`` over the mesh
dim's process group (NCCL between cards, gloo on the CPU). Five
decompositions, as in the reference:

* **Batch sharding** (:func:`batched_transform`, :func:`batched_rfft`,
  :func:`batched_irfft`): each rank runs whole transforms on its shard of
  the leading axis; no exchange.
* **Four-step large 1-D FFT** (:class:`FourStepPlan`): N = n1*n2 viewed as
  X[n1, n2], column-sharded; column FFTs, the split twiddle W_N^(k1*n2), an
  exchange to row-sharded, row FFTs. Output in digit order Y[k1, k2] =
  X[k1 + n1*k2], or flat in natural order after a second exchange.
* **2-D FFT** (:class:`Fft2dPlan`): row FFTs, exchange, column FFTs; the
  result row-sharded, or left transposed (one exchange saved).
* **3-D FFT** (:class:`Fft3dPlan`): pencils over a 2-D mesh, slabs over one
  mesh dim, with the ``spectral_output``/``from_spectral`` layout that
  halves the exchanges of a filter round trip.
* **Real-input 2-D and 3-D FFTs** (:class:`Rfft2dPlan`,
  :class:`Rfft3dPlan`): the r2c leg first, so every exchange and c2c leg
  runs on the one-sided spectrum, zero-padded to ``n2p`` to shard evenly.

Mesh dims are named as the JAX package names its mesh axes (``"batch"``,
``"fft"``, ``("x", "y")``). The planar calls take a DTensor whose
placements are the JAX ``in_specs`` (or the whole tensor, the same on every
rank) and return DTensors with the JAX ``out_specs``; ``transform``,
``rfft`` and ``irfft`` take and return the whole array on every rank, as
the JAX package returns a host array. Leading batch dims are replicated.

Layout: each leg runs its 1-D plan's batch-minor call (kernels B1-B8 on the
card) on a contiguous (n, B) plane, and lays its data so the exchange
splits that plane's leading dim, so a leg costs one copy
(:mod:`fourier_tpu_torch.parallel.exchange`), not the reference's swapaxes
around batch-major calls. The legs apply the mode's normalisation (each 1-D
plan scales its own axis), so no extra pass scales the result.
``pipeline_chunks`` > 1 slices a leg so that a chunk's exchange is in
flight while the next chunk's copy and kernel run; results are bitwise
those of one chunk.

c128 runs native f64 on the ``dd`` route's plans, so the JAX package's
double-word twins (``batched_transform_dd``, ``batched_rfft_dd``,
``batched_irfft_dd``, ``transform_planar_dd``) are not ported (ROADMAP.md
queue 1 item 7). The plans are ``nn.Module`` s owning their sub-plans and
tables (the place of the pytree registration); ``mesh`` is an attribute.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from fourier_tpu_torch.ops import cplx
from fourier_tpu_torch.parallel import exchange as ex
from fourier_tpu_torch.plan.base import complex_dtype, resolve_device
from fourier_tpu_torch.plan.planner import create_fft
from fourier_tpu_torch.rfft import RfftPlan
from fourier_tpu_torch.transform import Transform

# ---------------------------------------------------------------------------
# Mesh plumbing: JAX PartitionSpec-like specs (a mesh dim name or None per
# tensor dim) as DTensor placements, and a rank's local block.
# ---------------------------------------------------------------------------


def _axis_size(mesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise KeyError(f"mesh has no dim {name!r}; its dims are {tuple(names)}")
    return mesh.size(names.index(name))


def _placements(mesh, spec) -> tuple:
    return tuple(Shard(spec.index(name)) if name in spec else Replicate()
                 for name in mesh.mesh_dim_names)


def _mesh_device(mesh) -> torch.device:
    return resolve_device(mesh.device_type)


def _local(t, mesh, spec, device, real_dtype, shape, what: str):
    """The rank's block of one plane: a DTensor with the placements of
    `spec`, or the whole tensor (numpy is moved to `device`). `shape`
    checks the trailing dims."""
    if isinstance(t, DTensor):
        if t.device_mesh != mesh or tuple(t.placements) != _placements(mesh, spec):
            raise ValueError(
                f"input placements {tuple(t.placements)} on {t.device_mesh} differ "
                f"from the plan's {_placements(mesh, spec)} on {mesh}")
        full, local = tuple(t.shape), t.to_local()
    else:
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(np.asarray(t), device=device)
        full = tuple(t.shape)
        local = None
    if full[len(full) - len(shape):] != tuple(shape) or len(full) < len(shape):
        raise ValueError(f"trailing axes {full[len(full) - len(shape):]} {what} "
                         f"{tuple(shape)}")
    # Before any collective: a rank's block must not drop rows (shard_map's
    # check, with its wording).
    for i, name in enumerate(mesh.mesh_dim_names):
        if name not in spec:
            continue
        d, sz = spec.index(name), mesh.size(i)
        if full[d] % sz:
            raise ValueError(
                f"input of shape {full} has axis sizes that are not evenly divisible "
                f"by the corresponding mesh axis sizes: array axis {d} (of size "
                f"{full[d]}) maps to mesh axis {name!r} (of size {sz}), but {sz} "
                f"does not evenly divide {full[d]}")
    if local is None:
        if t.device != device:
            raise ValueError(f"input on {t.device} but plan on {device}")
        coord = mesh.get_coordinate()
        for i, name in enumerate(mesh.mesh_dim_names):
            if name in spec:
                d = spec.index(name)
                k = t.shape[d] // mesh.size(i)
                t = t.narrow(d, coord[i] * k, k)
        local = t
    return local.to(real_dtype)


def _spec(nb: int, *tail) -> tuple:
    return (None,) * nb + tuple(tail)


def _inputs(planes, mesh, tail_spec, shape, device, real_dtype, what="!= plan shape"):
    """Local planes as (B, tail...) with the batch dims flattened, and the
    batch shape."""
    nb = len(planes[0].shape) - len(shape)
    if nb < 0:
        raise ValueError(f"input has {len(planes[0].shape)} dims, the plan needs "
                         f"at least {len(shape)}")
    spec = _spec(nb, *tail_spec)
    loc = [_local(p, mesh, spec, device, real_dtype, shape, what) for p in planes]
    if any(tuple(p.shape) != tuple(loc[0].shape) for p in loc):
        raise ValueError(f"plane shapes differ: {[tuple(p.shape) for p in loc]}")
    batch = tuple(loc[0].shape[:nb])
    return tuple(p.reshape(-1, *p.shape[nb:]) for p in loc), batch


def _outputs(planes, batch, mesh, tail_spec) -> tuple:
    """DTensors of the local (B, tail...) results, batch dims restored."""
    spec = _spec(len(batch), *tail_spec)
    return tuple(DTensor.from_local(p.reshape(*batch, *p.shape[1:]), mesh,
                                    _placements(mesh, spec), run_check=False)
                 for p in planes)


def _full(planes) -> tuple:
    return tuple(p.full_tensor() for p in planes)


def _as_array(x, device):
    """(`x` as a tensor on `device`, whether it came as numpy)."""
    if isinstance(x, torch.Tensor):
        return x, False
    return torch.as_tensor(np.asarray(x), device=device), True


def _owned(sizes, dtype, backend, device) -> list:
    """A 1-D plan of each size, owned by the caller (equal sizes share one)."""
    plans = {}
    for n in sizes:
        if n not in plans:
            plans[n] = create_fft(n, dtype, backend=backend, device=device, cache=False)
    return [plans[n] for n in sizes]


def _c2c(plan, mode: Transform):
    return ex.batch_minor(lambda re, im: plan.transform_planar_bm(re, im, mode))


def _split_twiddle(n1: int, n2: int, forward: bool) -> Tuple[np.ndarray, np.ndarray]:
    """f64 planar W_N^(±k1*n2) table of shape (n1, n2), plan-time numpy."""
    k1 = np.arange(n1, dtype=np.float64)[:, None]
    j2 = np.arange(n2, dtype=np.float64)[None, :]
    theta = 2.0 * np.pi * (k1 * j2) / float(n1 * n2)
    return np.cos(theta), (-np.sin(theta) if forward else np.sin(theta))


def _align(table: torch.Tensor, table_names, names) -> torch.Tensor:
    """A planar (2, ...) table over dims `table_names`, broadcast against
    planes whose dims are `names`."""
    kept = [n for n in names if n in table_names]
    t = table.permute(0, *(1 + table_names.index(n) for n in kept))
    return t.reshape(2, *(table.shape[1 + table_names.index(n)] if n in table_names
                          else 1 for n in names))


# ---------------------------------------------------------------------------
# Batch sharding
# ---------------------------------------------------------------------------


def _batched(planes, mesh, axis: str, step, real_dtype, device) -> tuple:
    """Run `step` along the last axis of every rank's shard of the leading
    axis: one copy into the (n, B) layout, none back (a permuted view)."""
    nd = len(planes[0].shape)
    spec = (axis,) + (None,) * (nd - 1)
    loc = [_local(p, mesh, spec, device, real_dtype, (), "") for p in planes]
    names = tuple(f"d{i}" for i in range(nd - 1)) + ("t",)
    out = ex.assemble(ex.leg([ex.local_blocks(loc, names)], "t", step), names)
    return tuple(DTensor.from_local(o, mesh, _placements(mesh, spec), run_check=False)
                 for o in out)


def batched_transform(plan, re, im, mesh, axis: str = "batch",
                      transform: Transform = Transform.FFT):
    """Batch-sharded batched FFT: the leading axis split over mesh dim
    `axis`, each rank running `plan` (a 1-D plan on the mesh's device) over
    the last axis of its shard. No exchange."""
    mode = Transform(transform)
    return _batched((re, im), mesh, axis, _c2c(plan, mode), plan.real_dtype, plan.device)


def batched_rfft(plan: RfftPlan, x, mesh, axis: str = "batch"):
    """Batch-sharded real-input FFT: every rank runs the :class:`RfftPlan`'s
    batch-minor call (B4a/B5a on the card) on its shard. Returns the planar
    (re, im) one-sided spectra."""
    return _batched((x,), mesh, axis, ex.batch_minor(plan.rfft_planar_bm),
                    plan.real_dtype, plan.device)


def batched_irfft(plan: RfftPlan, re, im, mesh, axis: str = "batch"):
    """Inverse of :func:`batched_rfft` (planar one-sided spectrum in, real
    signal out), batch-sharded, no exchange."""
    return _batched((re, im), mesh, axis, ex.batch_minor(plan.irfft_planar_bm),
                    plan.real_dtype, plan.device)[0]


# ---------------------------------------------------------------------------
# The sharded plans
# ---------------------------------------------------------------------------


class _ShardedPlan(torch.nn.Module):
    """Common surface of the sharded plans."""

    mesh: object
    dtype: torch.dtype
    size: int

    @property
    def real_dtype(self) -> torch.dtype:
        return torch.float32 if self.dtype == torch.complex64 else torch.float64

    @property
    def device(self) -> torch.device:
        return _mesh_device(self.mesh)

    def __len__(self) -> int:
        return self.size

    def _group(self, axis: Optional[str]):
        return None if axis is None else self.mesh.get_group(axis)

    def fft_planar(self, re, im):
        return self.transform_planar(re, im, Transform.FFT)

    def ifft_planar(self, re, im):
        return self.transform_planar(re, im, Transform.IFFT)

    def fft(self, x):
        return self.transform(x, Transform.FFT)

    def ifft(self, x):
        return self.transform(x, Transform.IFFT)

    def forward(self, x, transform: Transform = Transform.FFT):
        return self.transform(x, transform)

    def _complex(self, x, shape):
        """`x` as a complex tensor of the plan's dtype on its device, and
        whether it came as numpy; `shape` checks the trailing dims."""
        xt, as_numpy = _as_array(x, self.device)
        if tuple(xt.shape[max(xt.ndim - len(shape), 0):]) != tuple(shape):
            raise ValueError(f"trailing axes {tuple(xt.shape[-len(shape):])} != plan "
                             f"shape {tuple(shape)}")
        if not xt.is_complex() or xt.dtype != self.dtype:
            xt = xt.to(self.dtype)
        return xt, as_numpy

    @staticmethod
    def _join(planes, as_numpy: bool):
        out = torch.complex(*_full(planes))
        return out.detach().cpu().numpy() if as_numpy else out

    def _check_geometry(self, n1: int, n2: int, pipeline_major: int) -> None:
        nshards = _axis_size(self.mesh, self.axis)
        if n1 % nshards or n2 % nshards:
            raise ValueError(f"n1={n1} and n2={n2} must both be divisible by mesh "
                             f"axis size {nshards}")
        c = self.pipeline_chunks
        if c < 1:
            raise ValueError(f"pipeline_chunks must be >= 1, got {c}")
        if c > 1 and (pipeline_major // nshards) % c:
            raise ValueError(f"pipeline_chunks={c} must divide the local shard extent "
                             f"{pipeline_major // nshards}")

    @property
    def nshards(self) -> int:
        return _axis_size(self.mesh, self.axis)


class FourStepPlan(_ShardedPlan):
    """Large 1-D FFT of size n1*n2 sharded over mesh dim `axis`.

    With n = n1*N2 + n2 and k = k1 + N1*k2,
      X[k1 + N1*k2] = sum_{n2} W_N2^(n2*k2) * [ W_N^(n2*k1)
                        * sum_{n1} x[n1*N2 + n2] * W_N1^(n1*k1) ].
    Column FFTs (columns whole on each rank), the split twiddle, the
    exchange (the one collective), row FFTs. Planar input (..., n1, n2) is
    column-sharded, output Y[k1, k2] = X[k1 + n1*k2] row-sharded ("digit
    order"), or with ``natural_order=True`` the flat natural-order
    spectrum, contiguously sharded, after a second exchange. ``transform``
    takes the flat (..., n1*n2) signal. The split twiddle is f64 at plan
    time, cast to the plan's dtype; each rank holds its own columns.
    """

    def __init__(self, n1: int, n2: int, mesh, axis: str = "fft",
                 dtype=torch.complex64, natural_order: bool = False,
                 pipeline_chunks: int = 1, backend: str = "auto"):
        super().__init__()
        n1, n2 = int(n1), int(n2)
        self._setup(n1, n2, mesh, axis, complex_dtype(dtype), natural_order,
                    pipeline_chunks, backend)
        self.col_plan, self.row_plan = _owned((n1, n2), self.dtype, backend, self.device)
        self._tables(_split_twiddle(n1, n2, True), _split_twiddle(n1, n2, False))

    def _setup(self, n1, n2, mesh, axis, dtype, natural_order, pipeline_chunks,
               backend) -> None:
        self.n1, self.n2, self.size = n1, n2, n1 * n2
        self.mesh, self.axis, self.dtype = mesh, axis, dtype
        self.natural_order = bool(natural_order)
        self.pipeline_chunks = int(pipeline_chunks)
        self.backend = backend
        self._check_geometry(n1, n2, pipeline_major=n2)

    def _tables(self, fwd, inv) -> None:
        """Buffers of this rank's columns of the full (re, im) tables."""
        w = self.n2 // self.nshards
        c0 = self.mesh.get_local_rank(self.axis) * w
        for name, (tr, ti) in (("tw_fwd", fwd), ("tw_inv", inv)):
            t = np.stack([np.asarray(tr)[:, c0:c0 + w], np.asarray(ti)[:, c0:c0 + w]])
            self.register_buffer(name, torch.as_tensor(t, device=self.device).to(
                self.real_dtype), persistent=False)

    def aux(self) -> tuple:
        """The plan's structure, as the JAX package saves it."""
        return (self.n1, self.n2, self.axis, str(self.dtype).replace("torch.", ""),
                self.natural_order, self.pipeline_chunks, self.backend, self.mesh)

    def parts(self) -> list:
        """The full twiddle tables (every rank's columns) and the sub-plans,
        as the JAX package saves them."""
        rt = self.real_dtype
        full = [tuple(torch.as_tensor(t).to(rt) for t in _split_twiddle(
            self.n1, self.n2, fwd)) for fwd in (True, False)]
        return [*full, self.col_plan, self.row_plan]

    @classmethod
    def from_aux(cls, aux, parts) -> "FourStepPlan":
        """A plan from :meth:`aux` and the full tables and sub-plans."""
        n1, n2, axis, dtype, natural_order, chunks, backend, mesh = aux
        tw_fwd, tw_inv, col, row = parts
        plan = cls.__new__(cls)
        torch.nn.Module.__init__(plan)
        plan._setup(n1, n2, mesh, axis, complex_dtype(dtype), natural_order, chunks,
                    backend)
        plan.col_plan, plan.row_plan = _adopt((col, row), plan)
        plan._tables(tw_fwd, tw_inv)
        return plan

    def extra_repr(self) -> str:
        return (f"n1={self.n1}, n2={self.n2}, axis={self.axis!r}, dtype={self.dtype}, "
                f"natural_order={self.natural_order}, "
                f"pipeline_chunks={self.pipeline_chunks}")

    def _local_steps(self, re, im, mode: Transform):
        group = self._group(self.axis)
        tw = self.tw_fwd if mode.is_forward else self.tw_inv
        col = _c2c(self.col_plan, mode)

        def col_twiddle(b):
            b = col(b)
            s0 = b.start.get("n2", 0)
            t = _align(tw[:, :, s0:s0 + b.extent("n2")], ("n1", "n2"), b.names)
            return b._replace(planes=cplx.mul(b.planes, (t[0], t[1])))

        x = ex.local_blocks((re, im), ("b", "n1", "n2"))
        p = ex.leg([x], "n1", col_twiddle, group, "n2", chunk="n2",
                   chunks=self.pipeline_chunks)
        y = ex.leg(p, "n2", _c2c(self.row_plan, mode))
        if not self.natural_order:
            return ex.assemble(y, ("b", "n1", "n2"))
        y = [ex.exchange(y[0], group, "n1")]
        return ex.assemble(y, ("b", ("n2", "n1")))

    def transform_planar(self, re, im, transform: Transform = Transform.FFT):
        """Planar (re, im) of shape (..., n1, n2), sharded as (..., None,
        axis) (a DTensor, or the whole tensor): DTensors (..., n1, n2) as
        (..., axis, None) in digit order, or (..., n1*n2) as (..., axis) in
        natural order."""
        planes, batch = _inputs((re, im), self.mesh, (None, self.axis),
                                (self.n1, self.n2), self.device, self.real_dtype,
                                "do not match plan matrix shape")
        out = self._local_steps(*planes, Transform(transform))
        tail = (self.axis,) if self.natural_order else (self.axis, None)
        return _outputs(out, batch, self.mesh, tail)

    def transform(self, x, transform: Transform = Transform.FFT):
        """The whole flat (..., n1*n2) complex signal in, the whole result
        out: flat natural order with ``natural_order=True``, else the
        (..., n1, n2) digit-order matrix Y[k1, k2] = X[k1 + n1*k2]."""
        xt, as_numpy = self._complex(x, (self.size,))
        xt = xt.reshape(*xt.shape[:-1], self.n1, self.n2)
        return self._join(self.transform_planar(xt.real, xt.imag, transform), as_numpy)


class Fft2dPlan(_ShardedPlan):
    """2-D c2c FFT of shape (n1, n2), row-sharded over mesh dim `axis`.

    Row FFTs, the exchange, column FFTs. With ``transposed_output=True``
    the result stays in the transposed layout (..., n2, n1), row-sharded,
    saving the second exchange (a pointwise filter and the inverse with
    the axes' roles swapped follow). Planar input (..., n1, n2);
    ``pipeline_chunks=C`` overlaps the exchange with the row FFTs in C
    chunks (bitwise the same result).
    """

    def __init__(self, n1: int, n2: int, mesh, axis: str = "fft",
                 dtype=torch.complex64, transposed_output: bool = False,
                 pipeline_chunks: int = 1, backend: str = "auto"):
        super().__init__()
        n1, n2 = int(n1), int(n2)
        self._setup(n1, n2, mesh, axis, complex_dtype(dtype), transposed_output,
                    pipeline_chunks, backend)
        self.col_plan, self.row_plan = _owned((n1, n2), self.dtype, backend, self.device)

    def _setup(self, n1, n2, mesh, axis, dtype, transposed_output, pipeline_chunks,
               backend) -> None:
        self.n1, self.n2, self.size = n1, n2, n1 * n2
        self.mesh, self.axis, self.dtype = mesh, axis, dtype
        self.transposed_output = bool(transposed_output)
        self.pipeline_chunks = int(pipeline_chunks)
        self.backend = backend
        self._check_geometry(n1, n2, pipeline_major=n1)

    def aux(self) -> tuple:
        return (self.n1, self.n2, self.axis, str(self.dtype).replace("torch.", ""),
                self.transposed_output, self.pipeline_chunks, self.backend, self.mesh)

    def parts(self) -> list:
        return [self.col_plan, self.row_plan]

    @classmethod
    def from_aux(cls, aux, parts) -> "Fft2dPlan":
        n1, n2, axis, dtype, transposed, chunks, backend, mesh = aux
        plan = cls.__new__(cls)
        torch.nn.Module.__init__(plan)
        plan._setup(n1, n2, mesh, axis, complex_dtype(dtype), transposed, chunks, backend)
        plan.col_plan, plan.row_plan = _adopt(parts, plan)
        return plan

    def extra_repr(self) -> str:
        return (f"n1={self.n1}, n2={self.n2}, axis={self.axis!r}, dtype={self.dtype}, "
                f"transposed_output={self.transposed_output}, "
                f"pipeline_chunks={self.pipeline_chunks}")

    def _local_steps(self, re, im, mode: Transform):
        group = self._group(self.axis)
        x = ex.local_blocks((re, im), ("b", "n1", "n2"))
        p = ex.leg([x], "n2", _c2c(self.row_plan, mode), group, "n1", chunk="n1",
                   chunks=self.pipeline_chunks)
        y = ex.leg(p, "n1", _c2c(self.col_plan, mode))
        if self.transposed_output:
            return ex.assemble(y, ("b", "n2", "n1"))
        return ex.assemble([ex.exchange(y[0], group, "n2")], ("b", "n1", "n2"))

    def transform_planar(self, re, im, transform: Transform = Transform.FFT):
        """Planar (re, im) (..., n1, n2) sharded as (..., axis, None):
        DTensors (..., n1, n2), or (..., n2, n1) with ``transposed_output``,
        sharded as (..., axis, None)."""
        planes, batch = _inputs((re, im), self.mesh, (self.axis, None),
                                (self.n1, self.n2), self.device, self.real_dtype,
                                "do not match plan shape")
        out = self._local_steps(*planes, Transform(transform))
        return _outputs(out, batch, self.mesh, (self.axis, None))

    def transform(self, x, transform: Transform = Transform.FFT):
        """The whole (..., n1, n2) complex array in, the whole result out."""
        xt, as_numpy = self._complex(x, (self.n1, self.n2))
        return self._join(self.transform_planar(xt.real, xt.imag, transform), as_numpy)


class _Pencils(_ShardedPlan):
    """The 3-D plans' mesh dims: ``axes[0]`` shards n0 (natural layout) or
    n1 (spectral), ``axes[1]`` (none for the slab) n1 or n2."""

    def _setup_axes(self, n0, n1, n2, mesh, axes, dtype, spectral_output,
                    pipeline_chunks, backend) -> None:
        self.n0, self.n1, self.n2 = n0, n1, n2
        self.size = n0 * n1 * n2
        self.mesh = mesh
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) not in (1, 2):
            raise ValueError(f"axes must name 1 (slab) or 2 (pencil) mesh axes, got "
                             f"{axes!r}")
        self.axes = axes
        self.dtype = dtype
        self.spectral_output = bool(spectral_output)
        self.pipeline_chunks = int(pipeline_chunks)
        if self.pipeline_chunks < 1:
            raise ValueError(f"pipeline_chunks must be >= 1, got {self.pipeline_chunks}")
        self.backend = backend

    @property
    def axis_b(self) -> Optional[str]:
        return self.axes[1] if len(self.axes) == 2 else None

    def _sizes(self) -> Tuple[int, int]:
        sa = _axis_size(self.mesh, self.axes[0])
        sb = _axis_size(self.mesh, self.axis_b) if self.axis_b else 1
        return sa, sb

    @property
    def nshards(self) -> int:
        sa, sb = self._sizes()
        return sa * sb

    def _check_a(self, sa: int) -> None:
        if self.n0 % sa or self.n1 % sa:
            raise ValueError(f"n0={self.n0} and n1={self.n1} must both be divisible by "
                             f"mesh axis {self.axes[0]!r} size {sa}")

    def _specs(self):
        """(natural, spectral) trailing specs."""
        return ((self.axes[0], self.axis_b, None), (None, self.axes[0], self.axis_b))

    def _common_repr(self) -> str:
        return (f"n0={self.n0}, n1={self.n1}, n2={self.n2}, axes={self.axes!r}, "
                f"dtype={self.dtype}")


class Fft3dPlan(_Pencils):
    """3-D c2c FFT of shape (n0, n1, n2), pencil-decomposed over a 2-D mesh.

    Natural layout shards n0 over ``axes[0]`` and n1 over ``axes[1]``; each
    rank owns whole n2 lines. FFT along n2, exchange over ``axes[1]``
    (split n2, gather n1), FFT along n1, exchange over ``axes[0]`` (split
    n1, gather n0), FFT along n0: the **spectral layout** (k1 over
    ``axes[0]``, k2 over ``axes[1]``). Two mirror exchanges restore the
    natural layout unless ``spectral_output=True``; the inverse with
    ``from_spectral=True`` consumes the spectral layout, so a filter round
    trip costs 4 exchanges, not 8. One mesh dim (``axes=("fft",)``) is the
    slab decomposition. Planar input (..., n0, n1, n2).
    """

    def __init__(self, n0: int, n1: int, n2: int, mesh, axes=("x", "y"),
                 dtype=torch.complex64, spectral_output: bool = False,
                 pipeline_chunks: int = 1, backend: str = "auto"):
        super().__init__()
        n0, n1, n2 = int(n0), int(n1), int(n2)
        self._setup(n0, n1, n2, mesh, axes, complex_dtype(dtype), spectral_output,
                    pipeline_chunks, backend)
        self.plan0, self.plan1, self.plan2 = _owned((n0, n1, n2), self.dtype, backend,
                                                    self.device)

    def _setup(self, n0, n1, n2, mesh, axes, dtype, spectral_output, pipeline_chunks,
               backend) -> None:
        self._setup_axes(n0, n1, n2, mesh, axes, dtype, spectral_output,
                         pipeline_chunks, backend)
        sa, sb = self._sizes()
        self._check_a(sa)
        if n1 % sb or n2 % sb:
            raise ValueError(f"n1={n1} and n2={n2} must both be divisible by mesh "
                             f"axis {self.axes[1]!r} size {sb}")

    def aux(self) -> tuple:
        return (self.n0, self.n1, self.n2, self.axes, str(self.dtype).replace("torch.", ""),
                self.spectral_output, self.pipeline_chunks, self.backend, self.mesh)

    def parts(self) -> list:
        return [self.plan0, self.plan1, self.plan2]

    @classmethod
    def from_aux(cls, aux, parts) -> "Fft3dPlan":
        n0, n1, n2, axes, dtype, spectral, chunks, backend, mesh = aux
        plan = cls.__new__(cls)
        torch.nn.Module.__init__(plan)
        plan._setup(n0, n1, n2, mesh, axes, complex_dtype(dtype), spectral, chunks,
                    backend)
        plan.plan0, plan.plan1, plan.plan2 = _adopt(parts, plan)
        return plan

    def extra_repr(self) -> str:
        return (f"{self._common_repr()}, spectral_output={self.spectral_output}, "
                f"pipeline_chunks={self.pipeline_chunks}")

    def _local_steps(self, re, im, mode: Transform, from_spectral: bool):
        ga, gb = self._group(self.axes[0]), self._group(self.axis_b)
        c = self.pipeline_chunks
        k0, k1, k2 = (_c2c(p, mode) for p in (self.plan0, self.plan1, self.plan2))
        names = ("b", "n0", "n1", "n2")
        x = ex.local_blocks((re, im), names)
        if from_spectral:
            p = ex.leg([x], "n0", k0, ga, "n1", chunk="n2", chunks=c)
            p = (ex.leg(p, "n1", k1, gb, "n2", chunk="n0", chunks=c) if gb
                 else ex.leg(p, "n1", k1))
            return ex.assemble(ex.leg(p, "n2", k2), names)
        p = ex.leg([x], "n2", k2, gb, "n1", chunk="n0", chunks=c) if gb else ex.leg(
            [x], "n2", k2)
        p = ex.leg(p, "n1", k1, ga, "n0", chunk="n2", chunks=c)
        y = ex.leg(p, "n0", k0)
        if not self.spectral_output:
            y = [ex.exchange(y[0], ga, "n1")]
            if gb:
                y = ex.leg(y, "n1", None, gb, "n2")
        return ex.assemble(y, names)

    def transform_planar(self, re, im, transform: Transform = Transform.FFT,
                         from_spectral: bool = False):
        """Planar (re, im) (..., n0, n1, n2) in the natural layout, or the
        spectral one with ``from_spectral=True``: DTensors in the spectral
        layout with ``spectral_output`` (and not ``from_spectral``), else the
        natural one (the logical array is the same)."""
        natural, spectral = self._specs()
        planes, batch = _inputs((re, im), self.mesh, spectral if from_spectral else natural,
                                (self.n0, self.n1, self.n2), self.device,
                                self.real_dtype, "do not match plan shape")
        out = self._local_steps(*planes, Transform(transform), from_spectral)
        tail = spectral if self.spectral_output and not from_spectral else natural
        return _outputs(out, batch, self.mesh, tail)

    def transform(self, x, transform: Transform = Transform.FFT,
                  from_spectral: bool = False):
        """The whole (..., n0, n1, n2) complex array in, the whole result out."""
        xt, as_numpy = self._complex(x, (self.n0, self.n1, self.n2))
        return self._join(self.transform_planar(xt.real, xt.imag, transform,
                                                from_spectral), as_numpy)


class Rfft2dPlan(_ShardedPlan):
    """Real-input 2-D FFT of shape (n1, n2), row-sharded over mesh dim `axis`.

    The r2c twin of :class:`Fft2dPlan`: the rfft along rows halves the data
    before the exchange. The one-sided axis is zero-padded to ``n2p`` (the
    next multiple of the mesh dim's size) so it shards evenly; the pad rows
    are not sent, each rank zeroes its share. ``transposed_output=True``
    leaves the spectrum as (..., n2p, n1), sharded over k2; the inverse
    takes it with ``from_transposed=True`` (2 exchanges a round trip, not
    4). Planar spectra carry the pad tail; :meth:`rfft`/:meth:`irfft` crop
    and pad to numpy's shapes.
    """

    def __init__(self, n1: int, n2: int, mesh, axis: str = "fft",
                 dtype=torch.complex64, transposed_output: bool = False,
                 backend: str = "auto"):
        super().__init__()
        n1, n2 = int(n1), int(n2)
        self._setup(n1, n2, mesh, axis, complex_dtype(dtype), transposed_output, backend)
        self.rplan = RfftPlan(n2, self.dtype, backend=backend, device=self.device)
        (self.col_plan,) = _owned((n1,), self.dtype, backend, self.device)

    def _setup(self, n1, n2, mesh, axis, dtype, transposed_output, backend) -> None:
        self.n1, self.n2, self.size = n1, n2, n1 * n2
        self.mesh, self.axis, self.dtype = mesh, axis, dtype
        self.transposed_output = bool(transposed_output)
        self.backend = backend
        s = _axis_size(mesh, axis)
        if n1 % s:
            raise ValueError(f"n1={n1} must be divisible by mesh axis {axis!r} size {s}")
        self.out_len = n2 // 2 + 1
        self.n2p = s * ((self.out_len + s - 1) // s)

    def aux(self) -> tuple:
        return (self.n1, self.n2, self.axis, str(self.dtype).replace("torch.", ""),
                self.transposed_output, self.backend, self.mesh)

    def parts(self) -> list:
        return [self.rplan, self.col_plan]

    @classmethod
    def from_aux(cls, aux, parts) -> "Rfft2dPlan":
        n1, n2, axis, dtype, transposed, backend, mesh = aux
        plan = cls.__new__(cls)
        torch.nn.Module.__init__(plan)
        plan._setup(n1, n2, mesh, axis, complex_dtype(dtype), transposed, backend)
        plan.rplan, plan.col_plan = _adopt(parts, plan)
        return plan

    def extra_repr(self) -> str:
        return (f"n1={self.n1}, n2={self.n2}, axis={self.axis!r}, dtype={self.dtype}, "
                f"out_len={self.out_len}, n2p={self.n2p}, "
                f"transposed_output={self.transposed_output}")

    def rfft_planar(self, x):
        """A real plane (..., n1, n2) sharded as (..., axis, None): DTensors
        of the one-sided spectrum, (..., n1, n2p), or (..., n2p, n1) with
        ``transposed_output``, sharded as (..., axis, None)."""
        (x,), batch = _inputs((x,), self.mesh, (self.axis, None), (self.n1, self.n2),
                              self.device, self.real_dtype)
        group = self._group(self.axis)
        p = ex.leg([ex.local_blocks((x,), ("b", "n1", "n2"))], "n2",
                   ex.batch_minor(self.rplan.rfft_planar_bm), group, "n1",
                   padded=self.n2p)
        y = ex.leg(p, "n1", _c2c(self.col_plan, Transform.FFT),
                   sizes={"n2": self.n2p // self.nshards})
        if self.transposed_output:
            out = ex.assemble(y, ("b", "n2", "n1"))
        else:
            out = ex.assemble([ex.exchange(y[0], group, "n2")], ("b", "n1", "n2"))
        return _outputs(out, batch, self.mesh, (self.axis, None))

    def irfft_planar(self, re, im, from_transposed: bool = False):
        """One-sided spectrum planes (..., n1, n2p), or (..., n2p, n1) with
        ``from_transposed``, sharded as (..., axis, None): the real field
        (..., n1, n2), a DTensor sharded as (..., axis, None)."""
        shape = (self.n2p, self.n1) if from_transposed else (self.n1, self.n2p)
        planes, batch = _inputs((re, im), self.mesh, (self.axis, None), shape,
                                self.device, self.real_dtype,
                                "!= expected (planar spectra carry the pad tail)")
        group = self._group(self.axis)
        names = ("b", "n2", "n1") if from_transposed else ("b", "n1", "n2")
        p = [ex.local_blocks(planes, names)]
        if not from_transposed:
            p = ex.leg(p, "n2", None, group, "n1")
        p = ex.leg(p, "n1", _c2c(self.col_plan, Transform.IFFT), group, "n2")
        n = self.out_len  # the c2r leg reads the first n rows (a contiguous view)
        y = ex.leg(p, "n2", ex.batch_minor(
            lambda a, b: self.rplan.irfft_planar_bm(a[:n], b[:n])))
        (out,) = ex.assemble(y, ("b", "n1", "n2"))
        return _outputs((out,), batch, self.mesh, (self.axis, None))[0]

    def rfft(self, x):
        """np.fft.rfft2 analog: the whole real (..., n1, n2) in, the whole
        complex (..., n1, n2//2+1) out."""
        xt, as_numpy = _as_array(x, self.device)
        out = torch.complex(*_full(self.rfft_planar(xt.real if xt.is_complex() else xt)))
        if self.transposed_output:
            out = out.transpose(-1, -2)
        out = out[..., :self.out_len]
        return out.detach().cpu().numpy() if as_numpy else out

    def irfft(self, y):
        """np.fft.irfft2 analog: complex (..., n1, n2//2+1) in (the padded
        length too), real (..., n1, n2) out."""
        yt, as_numpy = _as_array(y, self.device)
        yt = _pad_spectrum(yt, self.out_len, self.n2p, self.dtype)
        if tuple(yt.shape[-2:]) != (self.n1, self.n2p):
            raise ValueError(f"trailing axes {tuple(yt.shape[-2:])} != ({self.n1}, "
                             f"{self.out_len} or {self.n2p})")
        out = self.irfft_planar(yt.real, yt.imag).full_tensor()
        return out.detach().cpu().numpy() if as_numpy else out


class Rfft3dPlan(_Pencils):
    """Real-input 3-D FFT of shape (n0, n1, n2), pencil-decomposed.

    r2c along n2 (n2//2+1 bins, zero-padded to ``n2p``, the next multiple
    of the ``axes[1]`` size), exchange over ``axes[1]``, c2c along n1,
    exchange over ``axes[0]``, c2c along n0: the spectral layout, with the
    ``spectral_output``/``from_spectral`` contract of :class:`Fft3dPlan`
    (4 exchanges a filtered round trip, not 8). Planar spectra are (...,
    n0, n1, n2p), the pad tail zero; :meth:`rfft`/:meth:`irfft` crop and
    pad to ``np.fft.rfftn``'s shapes. One mesh dim is the slab (no pad).
    """

    def __init__(self, n0: int, n1: int, n2: int, mesh, axes=("x", "y"),
                 dtype=torch.complex64, spectral_output: bool = False,
                 pipeline_chunks: int = 1, backend: str = "auto"):
        super().__init__()
        n0, n1, n2 = int(n0), int(n1), int(n2)
        self._setup(n0, n1, n2, mesh, axes, complex_dtype(dtype), spectral_output,
                    pipeline_chunks, backend)
        self.rplan = RfftPlan(n2, self.dtype, backend=backend, device=self.device)
        self.plan0, self.plan1 = _owned((n0, n1), self.dtype, backend, self.device)

    def _setup(self, n0, n1, n2, mesh, axes, dtype, spectral_output, pipeline_chunks,
               backend) -> None:
        self._setup_axes(n0, n1, n2, mesh, axes, dtype, spectral_output,
                         pipeline_chunks, backend)
        sa, sb = self._sizes()
        self._check_a(sa)
        if n1 % sb:
            raise ValueError(f"n1={n1} must be divisible by mesh axis {self.axes[1]!r} "
                             f"size {sb}")
        self.out_len = n2 // 2 + 1
        self.n2p = sb * ((self.out_len + sb - 1) // sb)

    def aux(self) -> tuple:
        return (self.n0, self.n1, self.n2, self.axes, str(self.dtype).replace("torch.", ""),
                self.spectral_output, self.pipeline_chunks, self.backend, self.mesh)

    def parts(self) -> list:
        return [self.rplan, self.plan0, self.plan1]

    @classmethod
    def from_aux(cls, aux, parts) -> "Rfft3dPlan":
        n0, n1, n2, axes, dtype, spectral, chunks, backend, mesh = aux
        plan = cls.__new__(cls)
        torch.nn.Module.__init__(plan)
        plan._setup(n0, n1, n2, mesh, axes, complex_dtype(dtype), spectral, chunks,
                    backend)
        plan.rplan, plan.plan0, plan.plan1 = _adopt(parts, plan)
        return plan

    def extra_repr(self) -> str:
        return (f"{self._common_repr()}, out_len={self.out_len}, n2p={self.n2p}, "
                f"spectral_output={self.spectral_output}, "
                f"pipeline_chunks={self.pipeline_chunks}")

    def rfft_planar(self, x):
        """A real field (..., n0, n1, n2) in the natural layout: DTensors of
        the one-sided spectrum (..., n0, n1, n2p), in the spectral layout
        with ``spectral_output``, else the natural one."""
        natural, spectral = self._specs()
        (x,), batch = _inputs((x,), self.mesh, natural, (self.n0, self.n1, self.n2),
                              self.device, self.real_dtype)
        ga, gb = self._group(self.axes[0]), self._group(self.axis_b)
        c = self.pipeline_chunks
        names = ("b", "n0", "n1", "n2")
        rf = ex.batch_minor(self.rplan.rfft_planar_bm)
        x = ex.local_blocks((x,), names)
        sizes = None
        if gb:
            p = ex.leg([x], "n2", rf, gb, "n1", chunk="n0", chunks=c, padded=self.n2p)
            sizes = {"n2": self.n2p // self._sizes()[1]}
        else:
            p = ex.leg([x], "n2", rf)
        p = ex.leg(p, "n1", _c2c(self.plan1, Transform.FFT), ga, "n0", chunk="n2",
                   chunks=c, sizes=sizes)
        y = ex.leg(p, "n0", _c2c(self.plan0, Transform.FFT))
        if not self.spectral_output:
            y = [ex.exchange(y[0], ga, "n1")]
            if gb:
                y = ex.leg(y, "n1", None, gb, "n2")
        out = ex.assemble(y, names)
        return _outputs(out, batch, self.mesh, spectral if self.spectral_output else natural)

    def irfft_planar(self, re, im, from_spectral: bool = False):
        """One-sided spectrum planes (..., n0, n1, n2p), natural layout or
        the spectral one with ``from_spectral``: the real field (..., n0,
        n1, n2), a DTensor in the natural layout."""
        natural, spectral = self._specs()
        planes, batch = _inputs(
            (re, im), self.mesh, spectral if from_spectral else natural,
            (self.n0, self.n1, self.n2p), self.device, self.real_dtype,
            "!= spectral shape (the planar spectrum carries the pad tail)")
        ga, gb = self._group(self.axes[0]), self._group(self.axis_b)
        c = self.pipeline_chunks
        names = ("b", "n0", "n1", "n2")
        p = [ex.local_blocks(planes, names)]
        if not from_spectral:
            if gb:
                p = ex.leg(p, "n2", None, gb, "n1")
            p = ex.leg(p, "n1", None, ga, "n0")
        p = ex.leg(p, "n0", _c2c(self.plan0, Transform.IFFT), ga, "n1", chunk="n2",
                   chunks=c)
        k1 = _c2c(self.plan1, Transform.IFFT)
        p = ex.leg(p, "n1", k1, gb, "n2", chunk="n0", chunks=c) if gb else ex.leg(
            p, "n1", k1)
        n = self.out_len
        y = ex.leg(p, "n2", ex.batch_minor(
            lambda a, b: self.rplan.irfft_planar_bm(a[:n], b[:n])))
        (out,) = ex.assemble(y, names)
        return _outputs((out,), batch, self.mesh, natural)[0]

    def rfft(self, x):
        """np.fft.rfftn analog: the whole real (..., n0, n1, n2) in, the
        whole complex (..., n0, n1, n2//2+1) out."""
        xt, as_numpy = _as_array(x, self.device)
        out = torch.complex(*_full(self.rfft_planar(xt.real if xt.is_complex() else xt)))
        out = out[..., :self.out_len]
        return out.detach().cpu().numpy() if as_numpy else out

    def irfft(self, y):
        """np.fft.irfftn analog: complex (..., n0, n1, n2//2+1) in (the
        padded length too), real (..., n0, n1, n2) out."""
        yt, as_numpy = _as_array(y, self.device)
        yt = _pad_spectrum(yt, self.out_len, self.n2p, self.dtype)
        if tuple(yt.shape[-3:]) != (self.n0, self.n1, self.n2p):
            raise ValueError(f"trailing axes {tuple(yt.shape[-3:])} != ({self.n0}, "
                             f"{self.n1}, {self.out_len} or {self.n2p})")
        out = self.irfft_planar(yt.real, yt.imag).full_tensor()
        return out.detach().cpu().numpy() if as_numpy else out


def _pad_spectrum(y: torch.Tensor, out_len: int, n2p: int, dtype) -> torch.Tensor:
    """A one-sided spectrum of ``out_len`` bins zero-padded to ``n2p``."""
    y = y.to(dtype)
    if y.shape[-1] == out_len and n2p != out_len:
        y = torch.nn.functional.pad(y, (0, n2p - out_len))
    return y


def _adopt(plans: Sequence, owner: _ShardedPlan) -> list:
    """Sub-plans given to a plan (a loaded file's), checked to run where
    the owner's mesh does."""
    for p in plans:
        if p.device != owner.device:
            raise ValueError(f"sub-plan on {p.device} but the mesh runs on "
                             f"{owner.device}; load with device={str(owner.device)!r}")
    return list(plans)


#: The sharded plan classes by name (the plan files' allowlist entries).
PLANS = {cls.__name__: cls for cls in (FourStepPlan, Fft2dPlan, Fft3dPlan, Rfft2dPlan,
                                       Rfft3dPlan)}


def exchange_backend(plan) -> str:
    """The transport of a plan's exchanges: the mesh dims' process-group
    backend (NCCL between cards, gloo on the CPU)."""
    axis = getattr(plan, "axis", None) or plan.axes[0]
    return str(dist.get_backend(plan.mesh.get_group(axis))).upper()
