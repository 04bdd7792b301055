"""Save and load the port's own plans: the ``static_fft`` analog.

Port of ``fourier_tpu/plan/serialize.py``. A plan is nothing but its
structure (sizes, splits, schedules) and its tables, so :func:`save_plan`
writes the plan's buffers, every one as it is (the non-persistent twiddle
buffers, the kernels' own tables, the clustered bodies' ``pair_*`` tables),
beside a JSON description of its structure, and :func:`load_plan` rebuilds
the same plan from them through the constructors that take tables: no
plan-time trigonometry and no plan-time inner FFT runs, and every buffer of
the loaded plan is bitwise the saved plan's.

The file is a pickle-free ``.npz`` in the JAX package's layout: a tagged
JSON ``structure`` (plan nodes name their class and carry JSON ``aux`` data
and ``children``; tuples are tagged; array leaves index ``leaf_<i>``
arrays), ``version``, and a ``format`` tag of its own, so that a file of
either package read by the other's loader is refused with the name of the
right one (:func:`~fourier_tpu_torch.plan.convert.load_jax_plan` reads the
JAX package's files). Loading can only select classes of an explicit
allowlist of the port's plan classes; the tag tree is walked by the
helpers that ``convert.py`` uses for the JAX format.

The sharded plans (``fourier_tpu_torch.parallel``) are saved as the JAX
package saves its own: their structure, the full tables (the four-step's
split twiddle, every rank's columns) and their sub-plans, the mesh as its
dim names and shape only. ``load_plan(..., mesh=...)`` rebinds them to a
mesh of that geometry, and each rank takes its own columns.
"""

from __future__ import annotations

import io
import json
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from fourier_tpu_torch.plan import convert
from fourier_tpu_torch.plan.autosort import AutosortPlan
from fourier_tpu_torch.plan.base import FftPlan, resolve_device
from fourier_tpu_torch.plan.bluestein import BluesteinPlan
from fourier_tpu_torch.plan.bluestein_fused import VpuBluesteinPlan
from fourier_tpu_torch.plan.four_step_local import FourStepLocalPlan
from fourier_tpu_torch.plan.mxu import MxuFftPlan
from fourier_tpu_torch.plan.vpu import FusedStagesPlan, VpuFftPlan
from fourier_tpu_torch.precision import (DdFftPlan, DdMxuDirectPlan, DdSplitPow2Plan,
                                         DdSplitRadixPlan, VpuDdBluesteinPlan,
                                         VpuDdFftPlan)
from fourier_tpu_torch.rfft import RfftPlan

FORMAT = "fourier_tpu_torch"
FORMAT_VERSION = 1


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _pairs(arr):
    """(re, im) of a planar (2, ...) leaf."""
    return arr[0], arr[1]


def _stage_pairs(arr, shapes):
    """Per-stage (re, im) (m, r) tables of a (2, L) stage buffer."""
    out, off = [], 0
    for m, r in shapes:
        out.append((arr[0, off:off + m * r].reshape(m, r),
                    arr[1, off:off + m * r].reshape(m, r)))
        off += m * r
    return out


class _Codec(NamedTuple):
    """How one plan class is written and rebuilt: `aux(plan)` its static
    structure (JSON scalars and tuples), `children(plan)` its sub-plans and
    buffers in order (every buffer the plan has), `build(aux, children,
    device)` the plan from them."""
    cls: type
    aux: Callable
    children: Callable
    build: Callable


def _fused_stages(cls):
    def build(aux, kids, device):
        size, shapes = aux
        fwd, inv, *kernel = kids
        return cls(size, _stage_pairs(fwd, shapes), _stage_pairs(inv, shapes), device,
                   kernel_tables=dict(zip(FusedStagesPlan.KERNEL_BUFFERS, kernel)))
    return _Codec(cls, lambda p: (p.size, p._shapes),
                  lambda p: [p.fwd, p.inv] + [getattr(p, name)
                                              for name in FusedStagesPlan.KERNEL_BUFFERS],
                  build)


def _fused_bluestein(cls):
    def build(aux, kids, device):
        stages, *chirps = kids
        pairs = [_pairs(c) for c in chirps]
        return cls(aux[0], stages, pairs[:3], pairs[3:], device)
    return _Codec(cls, lambda p: (p.size,),
                  lambda p: [p.stages, *p.chirps(True), *p.chirps(False)], build)


def _dd_split(cls, aux, build):
    return _Codec(cls, aux, lambda p: [p.sub, p.tw_fwd, p.tw_inv], build)


def _mxu_build(aux, kids, device):
    size, n1, n2, impl, tb = aux
    flat = lambda tables: [a for t in tables for a in _pairs(t)]
    fwd, inv = kids
    return MxuFftPlan(size, n1, n2, flat(fwd), flat(inv), device, impl=impl, tb=tb)


_CODECS: Dict[str, _Codec] = {c.cls.__name__: c for c in (
    _Codec(AutosortPlan, lambda p: (p.size, p.radices, _dtype_name(p.dtype), p._shapes),
           lambda p: [p.fwd, p.inv],
           lambda aux, kids, device: AutosortPlan(
               aux[0], aux[1], aux[2], *(_stage_pairs(t, aux[3]) for t in kids),
               device)),
    _Codec(BluesteinPlan, lambda p: (p.size, _dtype_name(p.dtype)),
           lambda p: [p.inner, p.w_fwd, p.w_inv, p.x_fwd, p.x_inv],
           lambda aux, kids, device: BluesteinPlan(
               aux[0], aux[1], kids[0], *(_pairs(t) for t in kids[1:]), device=device)),
    _Codec(FourStepLocalPlan, lambda p: (p.size, p.p, p.q, _dtype_name(p.dtype)),
           lambda p: [p.col_plan, p.row_plan, p.tw_fwd, p.tw_inv],
           # the twiddles are held transposed, (2, q, p); the constructor takes (p, q)
           lambda aux, kids, device: FourStepLocalPlan(
               *aux, kids[0], kids[1], *((t[0].T, t[1].T) for t in kids[2:]), device)),
    _Codec(MxuFftPlan, lambda p: (p.size, p.n1, p.n2, p.impl, p.tb),
           lambda p: [tuple(getattr(p, f"{d}{j}") for j in range(p._ntables))
                      for d in ("fwd", "inv")],
           _mxu_build),
    _fused_stages(VpuFftPlan),
    _fused_stages(VpuDdFftPlan),
    _fused_bluestein(VpuBluesteinPlan),
    _fused_bluestein(VpuDdBluesteinPlan),
    _dd_split(DdSplitPow2Plan, lambda p: (p.size,),
              lambda aux, kids, device: DdSplitPow2Plan(aux[0], *kids, device)),
    _dd_split(DdSplitRadixPlan, lambda p: (p.size, p.radix),
              lambda aux, kids, device: DdSplitRadixPlan(aux[0], aux[1], *kids, device)),
    _Codec(DdFftPlan, lambda p: (p.size,), lambda p: [p.body],
           lambda aux, kids, device: DdFftPlan.from_body(kids[0])),
    _Codec(DdMxuDirectPlan, lambda p: (p.size,), lambda p: [p.dft],
           lambda aux, kids, device: DdMxuDirectPlan(aux[0], *kids[0], device)),
    _Codec(RfftPlan, lambda p: (p.n, _dtype_name(p.dtype)), lambda p: [p.inner, p.w],
           lambda aux, kids, device: RfftPlan.from_parts(aux[0], aux[1], kids[0], kids[1])),
)}

#: The plan classes a plan file may name.
PLAN_CLASSES: Tuple[str, ...] = tuple(sorted((*_CODECS, *convert.SHARDED_CLASSES)))


def _codec(name: str):
    """The codec of plan class `name`, or None (the sharded plans' are made
    at first use)."""
    if name in convert.SHARDED_CLASSES and name not in _CODECS:
        from fourier_tpu_torch.parallel.sharded import PLANS

        cls = PLANS[name]
        _CODECS[name] = _Codec(cls, cls.aux, cls.parts,
                               lambda aux, kids, device, cls=cls: cls.from_aux(aux, kids))
    return _CODECS.get(name)


def _encode_aux(value):
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, tuple):
        return {"__tuple__": [_encode_aux(v) for v in value]}
    if isinstance(value, DeviceMesh):  # its geometry: load_plan rebinds a mesh
        return {"__mesh__": {"axis_names": list(value.mesh_dim_names or ()),
                             "shape": [int(s) for s in value.shape]}}
    raise TypeError(f"plan aux data of type {type(value).__name__} is not serializable")


def _encode(node, arrays: list):
    if node is None:
        return None
    if isinstance(node, torch.Tensor):
        arrays.append(node.detach().cpu().numpy())
        return {"__leaf__": len(arrays) - 1}
    if isinstance(node, tuple):
        return {"__tuple__": [_encode(c, arrays) for c in node]}
    name = type(node).__name__
    codec = _codec(name)
    if codec is None or type(node) is not codec.cls:
        raise TypeError(
            f"cannot serialize {name}: not a plan class of the port (known: "
            f"{list(PLAN_CLASSES)})")
    return {"__plan__": name, "aux": _encode_aux(codec.aux(node)),
            "children": [_encode(c, arrays) for c in codec.children(node)]}


def _decode(node, leaves, device, mesh=None):
    if isinstance(node, dict) and "__plan__" in node:
        name = node["__plan__"]
        codec = _codec(name)
        if codec is None:
            raise ValueError(
                f"unknown plan class {name!r} in plan file (known: {list(PLAN_CLASSES)})")
        aux = convert._aux(node["aux"], mesh)
        kids = [_decode(c, leaves, device, mesh) for c in node["children"]]
        return codec.build(aux, kids, device)
    return convert._tree(node, leaves)


def _to_arrays(plan) -> dict:
    arrays: list = []
    structure = _encode(plan, arrays)
    if not (isinstance(structure, dict) and "__plan__" in structure):
        raise TypeError(f"cannot serialize {type(plan).__name__}: not a plan")
    out = {f"leaf_{i}": a for i, a in enumerate(arrays)}
    out["structure"] = np.frombuffer(json.dumps(structure).encode("utf-8"), dtype=np.uint8)
    out["version"] = np.array([FORMAT_VERSION])
    out["format"] = np.frombuffer(FORMAT.encode("utf-8"), dtype=np.uint8)
    return out


def is_port_file(data) -> bool:
    """True for the arrays of a file this module wrote."""
    return "format" in data and bytes(np.asarray(data["format"]).tobytes()) == FORMAT.encode()


def save_plan(plan, path: str) -> None:
    """Write `plan` (a port plan of the allowlist, or an ``RfftPlan``) to
    `path` (.npz)."""
    arrays = _to_arrays(plan)  # before the file exists: a refused plan writes nothing
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def plan_to_bytes(plan) -> bytes:
    """In-memory variant of :func:`save_plan`."""
    buf = io.BytesIO()
    np.savez_compressed(buf, **_to_arrays(plan))
    return buf.getvalue()


def load_plan(path_or_bytes, device="cuda", mesh=None) -> FftPlan:
    """Rebuild on `device` (the card unless the caller asks for the CPU) a
    plan written by :func:`save_plan` (a path) or :func:`plan_to_bytes` (the
    bytes). Safe on untrusted files: no pickle is involved, and the file can
    only select plan classes of the allowlist and give their arrays.

    A sharded plan stores its mesh's dim names and shape only: pass
    ``mesh=`` with the same names and shape (on `device`) to rebind it."""
    device = resolve_device(device)
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    with np.load(src, allow_pickle=False) as data:
        if not is_port_file(data):
            if "structure" in data:
                raise ValueError("this plan file was written by fourier_tpu's save_plan "
                                 "(the JAX package); load it with load_jax_plan")
            raise ValueError("not a plan file written by save_plan")
        version = int(np.asarray(data["version"])[0])
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported plan format version {version}")
        structure = json.loads(bytes(np.asarray(data["structure"]).tobytes()).decode("utf-8"))
        leaves = {k: np.asarray(data[k]) for k in data.files if k.startswith("leaf_")}
    if not (isinstance(structure, dict) and "__plan__" in structure):
        raise ValueError("plan file holds no plan")
    return _decode(structure, leaves, device, mesh)
