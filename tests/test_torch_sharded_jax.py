"""The port's sharded plans against the JAX package's, on the same inputs.

The JAX side runs on four devices of the conftest's CPU mesh, the port on a
4-rank gloo world (``torch_sharded_world``). Three shapes, since each JAX
sharded plan compiles for 14-27 s here: ``FourStepPlan(16, 16,
pipeline_chunks=2)`` in digit order, ``Fft2dPlan(32, 16,
transposed_output=True)`` and ``Rfft3dPlan(8, 8, 8)`` on a 2x2 ``("x", "y")``
mesh with ``spectral_output=True``; the global arrays agree to rel-L2 <=
1e-6 (the pad tail included). Plan files the JAX package saved for each of
the five classes load with ``load_jax_plan`` and give the port's own plan's
results (the Fft2dPlan also the JAX run's); a double-word c128 file loads
too and its 4-plane call, joined to f64, matches the JAX run's, as does
``batched_transform_dd`` (gate 1e-12). ``summarize`` gives the JAX
package's kinds and cost model.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import fourier_tpu as jft
import torch_sharded_world as world_cases
from fourier_tpu.parallel import (Fft2dPlan, Fft3dPlan, FourStepPlan, Rfft2dPlan, Rfft3dPlan,
                                  batched_transform_dd)
from fourier_tpu.precision import ddreal as jddreal
from fourier_tpu.plan.summary import summarize as jsummarize

GATE = 1e-6
SEED = 0x5A4D


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _planar(x):
    return np.real(x).astype(np.float32), np.imag(x).astype(np.float32)


def _joined(planes):
    return np.asarray(planes[0]) + 1j * np.asarray(planes[1])


def _limbs(x):
    """The JAX package's double-word split of complex128 `x`: 4 f32 planes."""
    return (*jddreal.from_f64(x.real), *jddreal.from_f64(x.imag))


def _joined_dd(planes):
    planes = [np.asarray(p) for p in planes]
    return (jddreal.to_f64(planes[:2]) + 1j * jddreal.to_f64(planes[2:]))


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity")
    devs = np.array(jax.devices()[:4])
    fft, xy = Mesh(devs, ("fft",)), Mesh(devs.reshape(2, 2), ("x", "y"))
    rng = np.random.default_rng(SEED)

    def cx(shape, dtype=np.complex64):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)

    inputs = {"four": cx((16, 16)), "fft2d": cx((32, 16)),
              "rfft3d": rng.standard_normal((8, 8, 8)).astype(np.float32),
              "fft3d": cx((8, 8, 8)), "rfft2d": rng.standard_normal((16, 21)).astype(
                  np.float32), "fft2d_c128": cx((16, 16), np.complex128)}
    plans = {"four": FourStepPlan(16, 16, fft, pipeline_chunks=2),
             "fft2d": Fft2dPlan(32, 16, fft, transposed_output=True),
             "rfft3d": Rfft3dPlan(8, 8, 8, xy, spectral_output=True),
             "fft3d": Fft3dPlan(8, 8, 8, xy),
             "rfft2d": Rfft2dPlan(16, 21, fft),
             "fft2d_c128": Fft2dPlan(16, 16, fft, dtype=np.complex128, backend="stockham")}
    mesh_of = {"rfft3d": "xy", "fft3d": "xy"}
    files = {}
    for name, plan in plans.items():
        path = str(tmp / f"jax-{name}.npz")
        jft.save_plan(plan, path)
        kind = "real" if name.startswith("rfft") else "complex"
        files[name] = (path, mesh_of.get(name, "fft"), kind)
    dd_file = str(tmp / "jax-dd.npz")
    dd_plan = Fft2dPlan(16, 16, fft, dtype=np.complex128, backend="dd")
    jft.save_plan(dd_plan, dd_file)
    x_dd, x_batched = cx((16, 16), np.complex128), cx((8, 32), np.complex128)
    batch = Mesh(devs, ("batch",))
    jax_out = {
        "four": _joined(plans["four"].fft_planar(*_planar(inputs["four"]))),
        "fft2d": _joined(plans["fft2d"].fft_planar(*_planar(inputs["fft2d"]))),
        "rfft3d": _joined(plans["rfft3d"].rfft_planar(inputs["rfft3d"])),
        # under jit: one compile each (an eager shard_map over the double-word
        # arithmetic compiles op by op, ~170 s here)
        "dd": _joined_dd(jax.jit(dd_plan.transform_planar_dd)(*_limbs(x_dd))),
        "batched_dd": _joined_dd(jax.jit(lambda *p: batched_transform_dd(
            jft.create_fft(32, np.complex128, backend="dd"), *p, batch))(*_limbs(x_batched))),
    }
    extra = {"x_four": inputs["four"], "x_fft2d": inputs["fft2d"],
             "x_rfft3d": inputs["rfft3d"], "inputs": inputs, "files": files,
             "dd_file": dd_file, "x_dd": x_dd, "x_batched_dd": x_batched}
    port = world_cases.run_world(tmp, ["parity"], extra=extra)["parity"]
    if "error" in port:
        pytest.fail(port["error"])
    summaries = {k: jsummarize(plans[k]) for k in ("four", "fft2d", "rfft3d")}
    return {"jax": jax_out, "port": port, "inputs": inputs, "summaries": summaries,
            "x_dd": x_dd, "x_batched_dd": x_batched}


@pytest.mark.parametrize("name", ["four", "fft2d", "rfft3d"])
def test_sharded_plans_match_jax(parity, name):
    """FourStepPlan digit order with two chunks, Fft2dPlan transposed,
    Rfft3dPlan spectral on the 2x2 mesh: the whole arrays."""
    got, want = parity["port"][name], parity["jax"][name]
    assert _rel(got, want) <= GATE
    x = parity["inputs"][name].astype(np.complex128)
    ref = {"four": lambda: np.fft.fft(x.ravel()).reshape(16, 16).T,
           "fft2d": lambda: np.fft.fft2(x).T,
           "rfft3d": lambda: np.fft.rfftn(x.real)}[name]()
    assert _rel(got[..., :ref.shape[-1]], ref) <= GATE


@pytest.mark.parametrize("name", ["four", "fft2d", "rfft3d", "fft3d", "rfft2d",
                                  "fft2d_c128"])
def test_load_jax_plan_runs_the_saved_plan(parity, name):
    """Each JAX sharded plan file loads as the port's class, on the mesh
    given, and gives np.fft's result (the Fft2dPlan the JAX run's too)."""
    loaded = parity["port"]["loaded", name]
    x = parity["inputs"][name]
    assert loaded["type"] == {"four": "FourStepPlan", "fft2d": "Fft2dPlan",
                              "rfft3d": "Rfft3dPlan", "fft3d": "Fft3dPlan",
                              "rfft2d": "Rfft2dPlan", "fft2d_c128": "Fft2dPlan"}[name]
    x128 = x.astype(np.complex128)
    want = {"four": lambda: np.fft.fft(x128.ravel()).reshape(16, 16).T,
            "fft2d": lambda: np.fft.fft2(x128).T,
            "rfft3d": lambda: np.fft.rfftn(x.astype(np.float64)),
            "fft3d": lambda: np.fft.fftn(x128),
            "rfft2d": lambda: np.fft.rfft2(x.astype(np.float64)),
            "fft2d_c128": lambda: np.fft.fft2(x128)}[name]()
    got = loaded["y"][..., :want.shape[-1]]  # the real plans' pad tail cropped
    assert _rel(got, want) <= (1e-12 if name == "fft2d_c128" else 1e-5)
    if name in parity["jax"]:
        assert _rel(loaded["y"], parity["jax"][name]) <= GATE
        assert np.array_equal(loaded["y"], parity["port"][name])


def test_load_jax_plan_mesh_errors(parity):
    """A sharded file needs a mesh of its geometry; the double-word file
    loads as the port's Fft2dPlan over f64 sub-plans."""
    port = parity["port"]
    assert port["no_mesh"][0] == "ValueError" and "mesh=" in port["no_mesh"][1]
    assert port["wrong_mesh"][0] == "ValueError"
    assert "does not match the plan's mesh" in port["wrong_mesh"][1]
    assert port["dd_type"] == ("Fft2dPlan", "torch.complex128", False)


@pytest.mark.parametrize("name", ["dd", "batched_dd"])
def test_dd_matches_jax(parity, name):
    """The JAX package's double-word Fft2dPlan file, loaded, and
    batched_transform_dd on the same f32 limbs: the port's four planes,
    joined, against the JAX run's and np.fft."""
    got, want = parity["port"][name], parity["jax"][name]
    x = parity["x_" + ("dd" if name == "dd" else "batched_dd")]
    assert _rel(got, want) <= 1e-12
    ref = np.fft.fft2(x) if name == "dd" else np.fft.fft(x, axis=-1)
    assert _rel(got, ref) <= 1e-12


@pytest.mark.parametrize("name", ["four", "fft2d", "rfft3d"])
def test_summary_matches_jax(parity, name):
    """describe/summarize: the JAX package's kind, size, flops, bytes and
    stage count (the port names the transport where JAX says ICI)."""
    mine, ref = parity["port"]["summaries"][name], parity["summaries"][name]
    assert (mine["kind"], mine["size"], mine["bytes"], mine["stages"]) == (
        ref.kind, ref.size, ref.min_hbm_bytes_per_transform, len(ref.stages))
    assert mine["flops"] == pytest.approx(ref.flops_per_transform, rel=1e-12)
    assert mine["children"] == [c.kind for c in ref.children]
