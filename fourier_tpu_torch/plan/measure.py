"""Measured planning and wisdom: plan-time autotuning over plan families.

Port of ``fourier_tpu/plan/measure.py``. The static planner
(:func:`~fourier_tpu_torch.plan.planner.create_fft`) picks a plan family
by rules measured once; ``backend="measure"`` instead times every eligible
family for the exact ``(size, dtype)`` on the plan's device, through the
suite's timing core (``tools/bench_suite.py``: chained dependent
``SQRT_SCALED_FFT`` calls, one warm round, the median of 3, CUDA events on
the planes' stream), and remembers the winner in a process-wide **wisdom**
table. Wisdom round-trips to JSON (:func:`export_wisdom` /
:func:`import_wisdom`) in the JAX package's format (version 1, an
``entries`` table keyed ``"<platform>/<dtype>/<n>"``, each entry with
``backend``, ``timings_us``, ``batch`` and ``chain``), so a deployment tunes
once on its card and ships the table. The platform is the device type
(``cuda``, ``cpu``); an entry measured on the card also names the card
(``device_name``). A document the JAX package exported imports here: its
``tpu/...`` keys are kept, and a plan on the card never reads them.

Candidates on the card: complex64 ``vpu``, ``mxu`` and ``stockham``;
complex128 ``dd`` (the native-f64 route) and ``dd_xla``, the JAX package's
two on its chip: its ``dd_xla`` is the double-word XLA plan
(``DdFftPlan``), here the port's :class:`DdFftPlan`, the f64 Stockham or a
Bluestein over it (what ``stockham`` builds in complex128, so that label is
not timed twice). On the CPU only ``stockham`` is eligible, so nothing is
timed: as in the JAX package off its chip, the kernel families there would
time their plain versions, not the machine; the JAX package's CPU list
adds ``dd_xla``, the same plan here.

Like FFTW's wisdom, a winner holds for the batch it was timed at (stored
in the entry); a deployment with a very different batch should measure
again.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fourier_tpu_torch.plan.base import complex_dtype, resolve_device

WISDOM_VERSION = 1

#: The plan families a wisdom entry may name.
LABELS = ("vpu", "mxu", "stockham", "dd", "dd_xla")

# key "platform/dtype/size" -> entry dict (JSON-serializable)
_WISDOM: Dict[str, dict] = {}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _wisdom_key(platform: str, size: int, dtype: torch.dtype) -> str:
    return f"{platform}/{_dtype_name(dtype)}/{int(size)}"


def _plan_for_label(label: str, size: int, dtype: torch.dtype, device):
    """The plan a wisdom label names (no timing)."""
    from fourier_tpu_torch.plan import planner

    if label in ("vpu", "mxu", "stockham"):
        return planner.create_fft(size, dtype, backend=label, device=device, cache=False)
    if label == "dd":
        return planner._create_dd(size, dtype, device)
    if label == "dd_xla":
        from fourier_tpu_torch.precision import DdFftPlan

        return DdFftPlan(size, device=device)
    raise ValueError(f"unknown wisdom plan label {label!r}")


def _candidates(size: int, dtype: torch.dtype,
                device: torch.device) -> List[Tuple[str, Callable[[], object]]]:
    """(label, factory) of every family eligible on `device`: on the card
    the kernel families and the Stockham family (complex128: ``dd_xla``);
    on the CPU the Stockham family alone."""
    labels = ["stockham"]
    if device.type == "cuda":
        labels = (["vpu", "mxu", "stockham"] if dtype == torch.complex64
                  else ["dd", "dd_xla"])
    return [(label, lambda label=label: _plan_for_label(label, size, dtype, device))
            for label in labels]


def _time_plan(plan, size: int, batch: int, chain: int, iters: int) -> float:
    """Median steady-state seconds per batched SQRT_SCALED_FFT of `plan`:
    `chain` dependent calls a step, through ``transform_planar_bm`` on
    (size, batch) planes where the plan has a batch-minor path of its own,
    else ``transform_planar`` on (batch, size) planes."""
    from fourier_tpu_torch.tools.bench_suite import _time_steps, batch_minor
    from fourier_tpu_torch.transform import Transform

    mode = Transform.SQRT_SCALED_FFT  # unitary: chained magnitudes stay bounded
    bm = batch_minor(plan)
    call = plan.transform_planar_bm if bm else plan.transform_planar
    real = np.float32 if plan.dtype == torch.complex64 else np.float64
    rng = np.random.default_rng(0)
    shape = (size, batch) if bm else (batch, size)
    re, im = (torch.as_tensor(rng.standard_normal(shape).astype(real), device=plan.device)
              for _ in range(2))

    def step(re, im):
        for _ in range(chain):
            re, im = call(re, im, mode)
        return re, im

    return _time_steps(step, (re, im), chain, iters)


@dataclass
class MeasureResult:
    size: int
    dtype: str
    platform: str
    best: str
    timings_us: Dict[str, float] = field(default_factory=dict)
    plan: object = None


def measure_fft(size: int, dtype=torch.complex64, *, batch: Optional[int] = None,
                chain: Optional[int] = None, iters: int = 2, remember: bool = True,
                device="cuda") -> MeasureResult:
    """Time every eligible plan family for ``(size, dtype)`` on `device`
    (the card unless the caller asks for the CPU); pick the fastest.

    Times nothing when one family alone is eligible (the CPU). With
    `remember` the winner goes into the wisdom table, so that later
    ``create_fft(size, dtype, backend="measure")`` calls plan at once.
    """
    from fourier_tpu_torch.tools.bench_suite import default_batch

    dtype = complex_dtype(dtype)
    device = resolve_device(device)
    if batch is None:
        # A quarter of the suite's batch: enough columns to amortise the
        # per-call cost without the suite's footprint.
        batch = max(64, default_batch(size) // 4)
    if chain is None:
        chain = 8 if dtype == torch.complex128 else 32
    cands = _candidates(size, dtype, device)
    timings_us: Dict[str, float] = {}
    plans: Dict[str, object] = {}
    for label, factory in cands:
        plan = factory()
        plans[label] = plan
        if len(cands) == 1:
            timings_us[label] = 0.0  # sole candidate: no timing needed
            continue
        timings_us[label] = _time_plan(plan, size, batch, chain, iters) * 1e6
    if device.type == "cuda":
        # Each candidate's planes are free again; hand the cached blocks back.
        torch.cuda.empty_cache()
    best = min(timings_us, key=timings_us.get)
    platform = device.type
    result = MeasureResult(size=int(size), dtype=_dtype_name(dtype), platform=platform,
                           best=best, timings_us=timings_us, plan=plans[best])
    if remember:
        entry = {"backend": best,
                 "timings_us": {k: round(v, 3) for k, v in timings_us.items()},
                 "batch": int(batch), "chain": int(chain)}
        if device.type == "cuda":
            entry["device_name"] = torch.cuda.get_device_name(device)
        _WISDOM[_wisdom_key(platform, size, dtype)] = entry
    return result


def plan_from_wisdom(size: int, dtype, device="cuda") -> Optional[object]:
    """The plan of an earlier measurement's winner on `device`'s platform,
    or None where there is no wisdom."""
    dtype = complex_dtype(dtype)
    device = resolve_device(device)
    entry = _WISDOM.get(_wisdom_key(device.type, size, dtype))
    if entry is None:
        return None
    return _plan_for_label(entry["backend"], size, dtype, device)


def export_wisdom(path: Optional[str] = None) -> str:
    """Serialize the wisdom to JSON; write it to `path` if given."""
    doc = json.dumps({"version": WISDOM_VERSION, "entries": _WISDOM}, indent=2,
                     sort_keys=True)
    if path is not None:
        with open(path, "w") as f:
            f.write(doc)
    return doc


def _check_key(key) -> bool:
    parts = key.split("/") if isinstance(key, str) else ()
    return (len(parts) == 3 and parts[1] in ("complex64", "complex128")
            and parts[2].isdigit())


def import_wisdom(source: str) -> int:
    """Merge wisdom from a JSON string or a path to one; returns the number
    of entries merged. Every entry is checked first (the version, the key's
    shape, the family label), so a stale or foreign document cannot make
    ``backend="measure"`` build a plan of no known family later; nothing is
    merged from a document with one bad entry."""
    text = source
    if os.path.exists(source):
        with open(source) as f:
            text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"wisdom is not valid JSON: {e}") from e
    if not isinstance(doc, dict) or doc.get("version") != WISDOM_VERSION:
        raise ValueError(f"unsupported wisdom document (want version={WISDOM_VERSION})")
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        raise ValueError("wisdom document has no entries table")
    for key, entry in entries.items():
        backend = entry.get("backend") if isinstance(entry, dict) else None
        if backend not in LABELS or not _check_key(key):
            raise ValueError(f"malformed wisdom entry {key!r}")
    _WISDOM.update(entries)
    return len(entries)


def forget_wisdom() -> None:
    _WISDOM.clear()
