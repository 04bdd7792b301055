"""Carry plans saved by the JAX package across to the port.

The JAX package's ``save_plan`` (``fourier_tpu/plan/serialize.py``) writes a
pickle-free ``.npz``: a JSON ``structure`` tree (plan nodes name their class
and carry JSON ``aux`` data and ``children``; tuples are tagged; array leaves
index ``leaf_<i>`` arrays) and ``version`` 2. :func:`load_jax_plan` reads that
format with numpy and json only and builds the port's plan from its tables.
"""

from __future__ import annotations

import json
from typing import Mapping, Union

import numpy as np

from fourier_tpu_torch.ops.cuda.stockham_vpu import radix_schedule
from fourier_tpu_torch.plan.autosort import AutosortPlan
from fourier_tpu_torch.plan.base import FftPlan
from fourier_tpu_torch.plan.bluestein import BluesteinPlan
from fourier_tpu_torch.plan.bluestein_fused import VpuBluesteinPlan
from fourier_tpu_torch.plan.four_step_local import FourStepLocalPlan
from fourier_tpu_torch.plan.mxu import MxuFftPlan, check_impl
from fourier_tpu_torch.plan.vpu import VpuFftPlan
from fourier_tpu_torch.rfft import RfftPlan

FORMAT_VERSION = 2

# Plan classes of the JAX package that have no port yet, and the ROADMAP.md
# item that ports them.
_NOT_PORTED = {
    "DdFftPlan": "queue 1 item 7",
    "VpuDdFftPlan": "queue 1 item 7",
    "VpuDdBluesteinPlan": "queue 1 item 7",
    "DdSplitPow2Plan": "queue 1 item 7",
    "DdSplitRadixPlan": "queue 1 item 7",
    "DdMxuDirectPlan": "queue 1 item 7",
    "FourStepPlan": "queue 1 item 12",
    "Fft2dPlan": "queue 1 item 12",
    "Fft3dPlan": "queue 1 item 12",
    "Rfft2dPlan": "queue 1 item 12",
    "Rfft3dPlan": "queue 1 item 12",
}


def _aux(node):
    if isinstance(node, dict):
        return tuple(_aux(v) for v in node["__tuple__"])
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


def _compact(tables, size):
    """The compact (m, r) stage tables of B1's schedule for `size` from the
    JAX package's (n/r, r) tables, whose rows repeat each row of the compact
    table `stride` times: every stride-th row restores it."""
    rows, stride = [], 1
    for (tr, ti), r in zip(tables, radix_schedule(size)):
        rows.append((tr[::stride], ti[::stride]))
        stride *= r
    return rows


def _build(node, leaves, device) -> FftPlan:
    name = node.get("__plan__")
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP.md {_NOT_PORTED[name]}"
        )
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
        fwd, inv = (_compact(_tree(c, leaves), size) for c in node["children"])
        return VpuFftPlan(size, fwd, inv, device)
    if name == "MxuFftPlan":
        size, n1, n2, _dtype, _interpret, _tb, impl = aux
        check_impl(impl)
        fwd, inv = (_tree(c, leaves) for c in node["children"])
        return MxuFftPlan(size, n1, n2, fwd, inv, device)
    if name == "VpuBluesteinPlan":
        size, m_inner = aux[:2]
        stage_tables, chirps_fwd, chirps_inv = (_tree(c, leaves)
                                                for c in node["children"])
        fwd, inv = (_compact(t, m_inner) for t in stage_tables)
        stages = VpuFftPlan(m_inner, fwd, inv, device)
        return VpuBluesteinPlan(size, stages, chirps_fwd, chirps_inv, device)
    if name == "RfftPlan":
        n, dtype = aux
        inner_node, w_re, w_im = node["children"]
        # A double-word (dd) plan's inner raises here, naming item 7.
        inner = _build(inner_node, leaves, device)
        w = None
        if w_re is not None:
            w = np.stack([np.ravel(_tree(w_re, leaves)),
                          np.ravel(_tree(w_im, leaves))])
        return RfftPlan.from_parts(n, dtype, inner, w)
    if name == "FourStepLocalPlan":
        size, p, q, dtype = aux
        col, row = (_build(c, leaves, device) for c in node["children"][:2])
        tw_fwd, tw_inv = (_tree(c, leaves) for c in node["children"][2:])
        return FourStepLocalPlan(size, p, q, dtype, col, row, tw_fwd, tw_inv,
                                 device)
    raise ValueError(f"unknown plan class {name!r} in plan file")


def load_jax_plan(path_or_arrays: Union[str, Mapping[str, np.ndarray]],
                  device="cpu") -> FftPlan:
    """Build the port's plan from a JAX ``save_plan`` file (a path) or its
    arrays (a mapping such as the ``np.load`` result)."""
    if isinstance(path_or_arrays, Mapping):
        return _from_arrays(path_or_arrays, device)
    with np.load(path_or_arrays, allow_pickle=False) as data:
        return _from_arrays(data, device)


def _from_arrays(data, device) -> FftPlan:
    if "structure" not in data or "version" not in data:
        raise ValueError("not a plan file written by fourier_tpu's save_plan")
    version = int(np.asarray(data["version"])[0])
    if version != FORMAT_VERSION:
        raise ValueError(f"unsupported plan format version {version}")
    structure = json.loads(bytes(np.asarray(data["structure"]).tobytes()).decode("utf-8"))
    leaves = {k: np.asarray(data[k]) for k in data if k.startswith("leaf_")}
    return _build(structure, leaves, device)
