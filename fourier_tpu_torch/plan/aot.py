"""Ahead-of-time export of a plan's execution: the ``static_fft`` deliverable.

Port of ``fourier_tpu/plan/aot.py``. :func:`export_compiled` traces a plan's
``transform_planar`` at the chosen shapes with ``torch.export`` (one
``ExportedProgram`` per transform mode, the plan's tables constants of the
program) and saves the programs (``torch.export.save``) beside a JSON
``meta``. :func:`load_compiled` replays them with zero planning: it builds
no plan object, runs no trigonometry and traces nothing
(``torch.export.load(...).module()``).

On the card every kernel launch of the plan is a registered operator
(``fourier_tpu_torch::<name>``, ``ops/cuda/``), so the exported graph calls
the kernels themselves; importing ``fourier_tpu_torch`` registers them,
the one precondition of loading, as the Mosaic runtime is the JAX
package's. A plan on the CPU exports its plain PyTorch version.

Notes:

- The artifact records the device type it was exported on (and the card's
  name): export on the kind of device you will run on.
- Batch dimensions may be symbolic: a string in ``batch_shape`` (e.g.
  ``("b",)``) becomes a ``torch.export.Dim`` of that name.
"""

from __future__ import annotations

import io
import json
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from fourier_tpu_torch.transform import Transform

FORMAT = "fourier_tpu_torch.compiled"
FORMAT_VERSION = 1
OP_NAMESPACE = "fourier_tpu_torch"


def _mode_key(mode: Transform) -> str:
    return Transform(mode).name.lower()


class _PlanarCall(torch.nn.Module):
    """One mode of a plan's planar call, the module that is exported."""

    def __init__(self, plan, mode: Transform):
        super().__init__()
        self.plan = plan
        self.mode = Transform(mode)

    def forward(self, re, im):
        return self.plan.transform_planar(re, im, self.mode)


def graph_ops(program) -> list:
    """The ``fourier_tpu_torch::*`` operators an exported program (or its
    graph module) calls, in graph order."""
    graph = program.graph_module.graph if hasattr(program, "graph_module") else program.graph
    return [node.target.name() for node in graph.nodes
            if node.op == "call_function"
            and getattr(node.target, "namespace", None) == OP_NAMESPACE]


def export_compiled(plan, path: str, batch_shape: Sequence = (),
                    modes: Sequence[Transform] = (Transform.FFT, Transform.IFFT)) -> None:
    """Export `plan`'s planar execution and write it to `path` (.npz).

    One ``torch.export`` program per transform mode, over planar (re, im)
    inputs of shape ``(*batch_shape, plan.size)`` in the plan's real dtype on
    its device. ``batch_shape`` entries may be ints (static) or strings
    (symbolic batch dims, e.g. ``("b",)``; one name, one dimension).
    """
    dims: Dict[str, torch.export.Dim] = {}
    shape, dynamic = [], {}
    for i, d in enumerate(batch_shape):
        if isinstance(d, str):
            dynamic[i] = dims.setdefault(d, torch.export.Dim(d))
            shape.append(3 + 2 * len(dims))  # an example of no special size
        else:
            shape.append(int(d))
    shape.append(plan.size)
    # Two tensors: export would take one tensor passed twice for one input.
    example = tuple(torch.zeros(shape, dtype=plan.real_dtype, device=plan.device)
                    for _ in range(2))
    dynamic_shapes = (dynamic, dynamic) if dynamic else None

    out, mode_names, kernels = {}, [], {}
    for mode in modes:
        key = _mode_key(mode)
        with torch.no_grad():
            program = torch.export.export(_PlanarCall(plan, mode), example,
                                          dynamic_shapes=dynamic_shapes, strict=False)
        buf = io.BytesIO()
        torch.export.save(program, buf)
        out[f"program_{key}"] = np.frombuffer(buf.getvalue(), dtype=np.uint8)
        mode_names.append(key)
        kernels[key] = graph_ops(program)
    device = plan.device
    meta = {
        "format": FORMAT,
        "version": FORMAT_VERSION,
        "size": int(plan.size),
        "real_dtype": str(plan.real_dtype).replace("torch.", ""),
        "batch_shape": [d if isinstance(d, str) else int(d) for d in batch_shape],
        "modes": mode_names,
        "plan_class": type(plan).__name__,
        "device": device.type,
        "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else None),
        "kernels": kernels,
    }
    out["meta"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **out)


class CompiledFft:
    """A loaded artifact: runs with zero planning and zero tracing.

    The planar subset of the plan API (`transform_planar`, `fft_planar`,
    `ifft_planar`) for the modes it was exported with. Tensors in, tensors
    out; numpy planes run on the artifact's device and come back as numpy.
    """

    def __init__(self, size: int, real_dtype, modes, programs, meta):
        self.size = int(size)
        self.real_dtype = getattr(torch, real_dtype) if isinstance(real_dtype, str) else real_dtype
        self.modes = tuple(modes)
        self._programs = programs  # mode key -> the loaded program's module
        self.meta = meta

    def transform_planar(self, re, im, transform: Transform = Transform.FFT) -> Tuple:
        key = _mode_key(transform)
        if key not in self._programs:
            raise ValueError(f"mode {Transform(transform).name} was not exported; "
                             f"artifact has {sorted(self._programs)}")
        as_numpy = not isinstance(re, torch.Tensor)
        if as_numpy:
            device = "cuda" if self.meta["device"] == "cuda" else "cpu"
            re = torch.as_tensor(np.asarray(re), device=device)
            im = torch.as_tensor(np.asarray(im), device=device)
        ore, oim = self._programs[key](re.to(self.real_dtype), im.to(self.real_dtype))
        if as_numpy:
            return ore.cpu().numpy(), oim.cpu().numpy()
        return ore, oim

    def fft_planar(self, re, im):
        return self.transform_planar(re, im, Transform.FFT)

    def ifft_planar(self, re, im):
        return self.transform_planar(re, im, Transform.IFFT)

    def __len__(self) -> int:
        return self.size


def load_compiled(path: str) -> CompiledFft:
    """Load an :func:`export_compiled` artifact.

    No plan is rebuilt and nothing is traced: the saved programs (the
    plan's tables their constants) are loaded and called as they are.
    """
    with np.load(path, allow_pickle=False) as data:
        if "meta" not in data:
            raise ValueError("not a compiled-FFT artifact (missing meta)")
        meta = json.loads(bytes(data["meta"].tobytes()).decode("utf-8"))
        if meta.get("format") != FORMAT:
            raise ValueError("this artifact was written by fourier_tpu's export_compiled "
                             "(jax.export); it runs under the JAX package only")
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(f"unsupported compiled-FFT format version {meta.get('version')}")
        programs = {key: torch.export.load(io.BytesIO(data[f"program_{key}"].tobytes()))
                    .module() for key in meta["modes"]}
    return CompiledFft(meta["size"], meta["real_dtype"], meta["modes"], programs, meta)
