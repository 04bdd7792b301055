"""Carry plans saved by the JAX package across to the port.

The JAX package's ``save_plan`` (``fourier_tpu/plan/serialize.py``) writes a
pickle-free ``.npz``: a JSON ``structure`` tree (plan nodes name their class
and carry JSON ``aux`` data and ``children``; tuples are tagged; array leaves
index ``leaf_<i>`` arrays) and ``version`` 2. :func:`load_jax_plan` reads that
format with numpy and json only and builds the port's plan from its tables.

The JAX package's complex128 plans hold double-word tables, (hi, lo) f32
pairs in four planes (re_hi, re_lo, im_hi, im_lo); each f64 table is
rebuilt as float64(hi) + float64(lo), about 48 bits of the f64 value the
JAX package split. A ``DdFftPlan`` becomes the f64 :class:`AutosortPlan`
(kind stockham) or :class:`BluesteinPlan` (kind bluestein); a
``DdMxuDirectPlan`` the port's, its f64 DFT matrix the exact f64 sum of the
saved 7-bit chunk tables.

The JAX package's sharded plans (``fourier_tpu/parallel/sharded.py``) load
as the port's (``fourier_tpu_torch.parallel``) onto ``mesh``, a DeviceMesh
with the dim names and shape the file records: complex64, native-f64
complex128 and double-word complex128 plans alike (the double-word
sub-plans and tables rebuilt in f64 as above; the port's plan takes the
4-plane calls).
"""

from __future__ import annotations

import json
from typing import Mapping, Union

import numpy as np

import torch

from fourier_tpu_torch.ops.cuda.stockham_vpu import radix_schedule
from fourier_tpu_torch.ops.cuda.stockham_vpu_dd import radix_schedule_dd
from fourier_tpu_torch.plan.autosort import AutosortPlan
from fourier_tpu_torch.plan.base import FftPlan, resolve_device
from fourier_tpu_torch.plan.bluestein import BluesteinPlan
from fourier_tpu_torch.plan.bluestein_fused import VpuBluesteinPlan
from fourier_tpu_torch.plan.four_step_local import FourStepLocalPlan
from fourier_tpu_torch.plan.mxu import MxuFftPlan
from fourier_tpu_torch.plan.vpu import VpuFftPlan
from fourier_tpu_torch.precision import (DdMxuDirectPlan, DdSplitPow2Plan,
                                         DdSplitRadixPlan, VpuDdBluesteinPlan,
                                         VpuDdFftPlan)
from fourier_tpu_torch.rfft import RfftPlan

FORMAT_VERSION = 2

#: The sharded plan classes (``fourier_tpu_torch.parallel``, whose module
#: loads the DTensor machinery: imported where a plan file names one).
SHARDED_CLASSES = ("Fft2dPlan", "Fft3dPlan", "FourStepPlan", "Rfft2dPlan", "Rfft3dPlan")


def _aux(node, mesh=None):
    """A plan node's aux data: tuples untagged, a recorded mesh geometry
    rebound to `mesh` (which must match it)."""
    if isinstance(node, dict) and "__mesh__" in node:
        want = node["__mesh__"]
        if mesh is None:
            raise ValueError(
                "this plan file contains a sharded plan; pass load_plan(..., "
                f"mesh=...) with axes {want['axis_names']} of shape {want['shape']}")
        names = list(mesh.mesh_dim_names or ())
        shape = [int(s) for s in mesh.shape]
        if names != want["axis_names"] or shape != want["shape"]:
            raise ValueError(
                f"provided mesh (axes {names}, shape {shape}) does not match the plan's "
                f"mesh (axes {want['axis_names']}, shape {want['shape']})")
        return mesh
    if isinstance(node, dict):
        return tuple(_aux(v, mesh) for v in node["__tuple__"])
    return node


def _tree(node, leaves):
    """Children of a plan node: nested tuples of numpy leaves."""
    if node is None:
        return None
    if "__tuple__" in node:
        return tuple(_tree(c, leaves) for c in node["__tuple__"])
    if "__leaf__" in node:
        return np.asarray(leaves[f"leaf_{node['__leaf__']}"])
    raise ValueError("expected a tuple or an array leaf")


def _compact(tables, schedule):
    """The compact (m, r) stage tables of a fused kernel's `schedule` from
    the JAX package's (n/r, r) tables, whose rows repeat each row of the
    compact table `stride` times: every stride-th row restores it."""
    rows, stride = [], 1
    for (tr, ti), r in zip(tables, schedule):
        rows.append((tr[::stride], ti[::stride]))
        stride *= r
    return rows


def _f64(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def _dd(planes):
    """(re, im) f64 of a double-word table's four planes."""
    rh, rl, ih, il = planes
    return _f64(rh, rl), _f64(ih, il)


def _dd_tables(tables):
    return [_dd(t4) for t4 in tables]


def _dd_rows(tables):
    """Planar (2, rows, m) f64 of double-word rows of m entries."""
    pairs = [_dd(t4) for t4 in tables]
    return np.stack([np.stack([np.ravel(re) for re, _ in pairs]),
                     np.stack([np.ravel(im) for _, im in pairs])])


def _chunk_sum(chunks):
    """The f64 table of a ``DdMxuDirectPlan``'s fixed-point chunks: their
    sum, exact (each chunk is a 7-bit integer times its own power of two,
    49 bits in all)."""
    return np.sum([np.asarray(c, np.float64) for c in chunks], axis=0)


def _table(t):
    """A sharded plan's (re, im) table: a double-word one's four planes
    rebuilt in f64."""
    return _dd(t) if isinstance(t, tuple) and len(t) == 4 else t


def _build(node, leaves, device, mesh=None) -> FftPlan:
    name = node.get("__plan__")
    if name in SHARDED_CLASSES:
        from fourier_tpu_torch.parallel.sharded import PLANS

        is_plan = lambda c: isinstance(c, dict) and "__plan__" in c
        kids = [_build(c, leaves, device) if is_plan(c) else _table(_tree(c, leaves))
                for c in node["children"]]
        return PLANS[name].from_aux(_aux(node["aux"], mesh), kids)
    aux = _aux(node["aux"])
    if name == "AutosortPlan":
        size, radices, dtype = aux
        fwd, inv = (_tree(c, leaves) for c in node["children"])
        return AutosortPlan(size, radices, dtype, fwd, inv, device)
    if name == "BluesteinPlan":
        size, dtype = aux
        inner = _build(node["children"][0], leaves, device)
        tables = [_tree(c, leaves) for c in node["children"][1:]]
        return BluesteinPlan(size, dtype, inner, *tables, device=device)
    if name == "VpuFftPlan":
        size = aux[0]
        fwd, inv = (_compact(_tree(c, leaves), radix_schedule(size))
                    for c in node["children"])
        return VpuFftPlan(size, fwd, inv, device)
    if name == "VpuDdFftPlan":
        size = aux[0]
        fwd, inv = (_compact(_dd_tables(_tree(c, leaves)), radix_schedule_dd(size))
                    for c in node["children"])
        return VpuDdFftPlan(size, fwd, inv, device)
    if name == "VpuDdBluesteinPlan":
        size, m_inner = aux[:2]
        stage_tables, chirps_fwd, chirps_inv = (_tree(c, leaves)
                                                for c in node["children"])
        fwd, inv = (_compact(_dd_tables(t), radix_schedule_dd(m_inner))
                    for t in stage_tables)
        stages = VpuDdFftPlan(m_inner, fwd, inv, device)
        return VpuDdBluesteinPlan(size, stages, _dd_tables(chirps_fwd),
                                  _dd_tables(chirps_inv), device)
    if name == "DdSplitPow2Plan":
        sub = _build(node["children"][0], leaves, device)
        tw_fwd, tw_inv = (_dd_rows([_tree(c, leaves)]) for c in node["children"][1:])
        return DdSplitPow2Plan(aux[0], sub, tw_fwd, tw_inv, device)
    if name == "DdSplitRadixPlan":
        size, radix = aux
        sub = _build(node["children"][0], leaves, device)
        tw_fwd, tw_inv = (_dd_rows(_tree(c, leaves)) for c in node["children"][1:])
        return DdSplitRadixPlan(size, radix, sub, tw_fwd, tw_inv, device)
    if name == "DdFftPlan":
        if aux[0] == "stockham":
            _kind, size, radices = aux
            fwd, inv = (_dd_tables(_tree(c, leaves)) for c in node["children"])
            return AutosortPlan(size, radices, torch.complex128, fwd, inv, device)
        size = aux[1]
        inner = _build(node["children"][0], leaves, device)
        tables = [_dd(_tree(c, leaves)) for c in node["children"][1:]]
        return BluesteinPlan(size, torch.complex128, inner, *tables,
                             device=device)
    if name == "DdMxuDirectPlan":
        u, v = (_chunk_sum(_tree(c, leaves)) for c in node["children"][:2])
        return DdMxuDirectPlan(aux[0], u, v, device)
    if name == "MxuFftPlan":
        size, n1, n2, _dtype, _interpret, tb, impl = aux
        fwd, inv = (_tree(c, leaves) for c in node["children"])
        return MxuFftPlan(size, n1, n2, fwd, inv, device, impl=impl, tb=tb)
    if name == "VpuBluesteinPlan":
        size, m_inner = aux[:2]
        stage_tables, chirps_fwd, chirps_inv = (_tree(c, leaves)
                                                for c in node["children"])
        fwd, inv = (_compact(t, radix_schedule(m_inner)) for t in stage_tables)
        stages = VpuFftPlan(m_inner, fwd, inv, device)
        return VpuBluesteinPlan(size, stages, chirps_fwd, chirps_inv, device)
    if name == "RfftPlan":
        n, dtype = aux
        inner_node, w_re, w_im = node["children"]
        inner = _build(inner_node, leaves, device)
        w = None
        if w_re is not None:
            w_re, w_im = _tree(w_re, leaves), _tree(w_im, leaves)
            if isinstance(w_re, tuple):  # a dd plan's (hi, lo) pairs
                w_re, w_im = _f64(*w_re), _f64(*w_im)
            w = np.stack([np.ravel(w_re), np.ravel(w_im)])
        return RfftPlan.from_parts(n, dtype, inner, w)
    if name == "FourStepLocalPlan":
        size, p, q, dtype = aux
        col, row = (_build(c, leaves, device) for c in node["children"][:2])
        tw_fwd, tw_inv = (_tree(c, leaves) for c in node["children"][2:])
        return FourStepLocalPlan(size, p, q, dtype, col, row, tw_fwd, tw_inv,
                                 device)
    raise ValueError(f"unknown plan class {name!r} in plan file")


def load_jax_plan(path_or_arrays: Union[str, Mapping[str, np.ndarray]],
                  device="cuda", mesh=None) -> FftPlan:
    """Build the port's plan on `device` from a JAX ``save_plan`` file (a
    path) or its arrays (a mapping such as the ``np.load`` result). A
    sharded plan is rebound to ``mesh`` (on `device`), which must have the
    dim names and shape its file records."""
    device = resolve_device(device)
    if isinstance(path_or_arrays, Mapping):
        return _from_arrays(path_or_arrays, device, mesh)
    with np.load(path_or_arrays, allow_pickle=False) as data:
        return _from_arrays(data, device, mesh)


def _from_arrays(data, device, mesh=None) -> FftPlan:
    if "format" in data:  # the port's own files carry a format tag
        raise ValueError("this plan file was written by fourier_tpu_torch's save_plan; "
                         "load it with fourier_tpu_torch.load_plan")
    if "structure" not in data or "version" not in data:
        raise ValueError("not a plan file written by fourier_tpu's save_plan")
    version = int(np.asarray(data["version"])[0])
    if version != FORMAT_VERSION:
        raise ValueError(f"unsupported plan format version {version}")
    structure = json.loads(bytes(np.asarray(data["structure"]).tobytes()).decode("utf-8"))
    leaves = {k: np.asarray(data[k]) for k in data if k.startswith("leaf_")}
    return _build(structure, leaves, device, mesh)
