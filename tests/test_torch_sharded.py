"""The sharded plans of the port (``fourier_tpu_torch.parallel``) on a
4-rank gloo world of CPU processes: the counterparts of
``tests/test_sharded.py`` (its double-word c128 cases as native-f64 c128),
plus the output placements, the copies a leg makes, the exchanges of a
spectral round trip, the card's routes on their plain versions, the plan
files and the summaries.

The world runs once for the module (``torch_sharded_world.run_world``, a
jax-free module, so the children never load JAX); each case stays a test
of its own here. Inputs come from one numpy seed. Gates, rel-L2 over the
whole array against ``np.fft`` in f64 and against the port's single-device
surface on the CPU: complex64 <= 1e-6, the real family <= 1e-5, complex128
<= 1e-12; ``pipeline_chunks`` results bitwise equal to one chunk's.
"""

import numpy as np
import pytest
import torch

import fourier_tpu_torch as tft
import torch_sharded_world as world_cases
from fourier_tpu_torch import parallel

C64, RFFT, C128 = 1e-6, 1e-5, 1e-12
N2 = {"32-16": (32, 16), "16-48": (16, 48)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return world_cases.run_world(tmp_path_factory.mktemp("gloo"))


def res(world, name):
    r = world[name]
    if isinstance(r, dict) and "error" in r:
        pytest.fail(r["error"])
    return r


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def gate(got, want, tol):
    assert rel(got, want) <= tol


def cpu_plan(n, dtype=np.complex64):
    return tft.create_fft(n, dtype, device="cpu")


S0 = ["Shard(dim=0)"]
NATURAL3 = ["Shard(dim=0)", "Shard(dim=1)"]  # (x, y) over (n0, n1)
SPECTRAL3 = ["Shard(dim=1)", "Shard(dim=2)"]  # (x, y) over (k1, k2)


# -- batch sharding -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["c64", "c128"])
def test_batched_transform_matches_single(world, kind):
    r = res(world, f"batched_transform[{kind}]")
    x, tol = r["x"], C64 if kind == "c64" else C128
    x128 = x.astype(np.complex128)
    gate(r["y"], np.fft.fft(x128, axis=-1), tol)
    gate(r["y"], cpu_plan(x.shape[-1], x.dtype).fft(x), tol)
    gate(r["inv"], np.fft.ifft(x128, axis=-1), tol)
    assert r["placements"] == [S0, S0]


@pytest.mark.parametrize("case", ["96-c64", "27-c64", "64-c128", "128-vpu", "769-vpu"])
def test_batched_rfft_matches_single(world, case):
    """Even and odd n, c128, and the card's fused routes (B4a/B4b at 128,
    B5a/B5b at 769) on their plain versions."""
    r = res(world, f"batched_rfft[{case}]")
    x, tol = r["x"], C128 if case.endswith("c128") else RFFT
    gate(r["y"], np.fft.rfft(x.astype(np.float64)), tol)
    dtype = np.complex128 if case.endswith("c128") else np.complex64
    gate(r["y"], tft.RfftPlan(x.shape[-1], dtype, device="cpu").rfft(x), tol)
    gate(r["back"], x, tol)
    assert r["fused"] is case.endswith("vpu")
    assert r["placements"] == [S0] * 3


# -- FourStepPlan -------------------------------------------------------------


@pytest.mark.parametrize("n1,n2", [(16, 16), (32, 8), (24, 8)])
def test_four_step_natural_order(world, n1, n2):
    r = res(world, f"four_step_natural[{n1}-{n2}]")
    x = r["x"]
    gate(r["y"], np.fft.fft(x.astype(np.complex128)), C64)
    gate(r["y"], cpu_plan(n1 * n2).fft(x), C64)
    assert r["placements"] == [S0, S0]  # flat, contiguously sharded


def test_four_step_digit_order_and_inverse(world):
    r = res(world, "four_step_digit_order_and_inverse")
    x = r["x"].astype(np.complex128)
    gate(r["y"], np.fft.fft(x).reshape(16, 16).T, C64)  # Y[k1, k2] = X[k1 + n1*k2]
    gate(r["inv"], np.fft.ifft(x).reshape(16, 16).T, C64)
    assert r["placements"] == [S0, S0]


def test_four_step_roundtrip_natural(world):
    r = res(world, "four_step_roundtrip_natural")
    gate(r["back"], r["x"], C64)


def test_four_step_batch_dims_and_complex_api(world):
    r = res(world, "four_step_batch_dims_and_complex_api")
    x = r["x"]
    assert r["y"].shape == x.shape
    gate(r["y"], np.fft.fft(x.astype(np.complex128), axis=-1), C64)
    gate(r["y"], cpu_plan(256).fft(x), C64)
    gate(r["back"], x, C64)


@pytest.mark.parametrize("chunks", [2, 4])
def test_four_step_pipelined_equivalence(world, chunks):
    r = res(world, f"four_step_pipelined[{chunks}]")
    assert np.array_equal(r["base"], r["piped"])
    assert np.array_equal(r["digit"], r["digit_base"])
    gate(r["piped"], np.fft.fft(r["x"].astype(np.complex128).ravel()), C64)


@pytest.mark.parametrize("backend", ["dd", "stockham"])
def test_four_step_c128_natural_order(world, backend):
    r = res(world, f"four_step_c128_natural[{backend}]")
    gate(r["y"], np.fft.fft(r["x"]), C128)
    gate(r["back"], r["x"], C128)


# -- Fft2dPlan ----------------------------------------------------------------


@pytest.mark.parametrize("shape,mode", [(s, m) for s in N2 for m in ("FFT", "IFFT")]
                         + [("16-16", "SQRT"), ("16-16", "UNSCALED")])
def test_fft2d_vs_numpy(world, shape, mode):
    r = res(world, f"fft2d[{shape}-{mode}]")
    x = r["x"].astype(np.complex128)
    n = x.size
    want = {"FFT": np.fft.fft2(x), "IFFT": np.fft.ifft2(x),
            "SQRT": np.fft.fft2(x) / np.sqrt(n), "UNSCALED": np.fft.ifft2(x) * n}[mode]
    gate(r["y"], want, C64)
    assert r["placements"] == [S0, S0]
    if mode in ("FFT", "IFFT"):
        fn = tft.fft2 if mode == "FFT" else tft.ifft2
        gate(r["y"], fn(r["x"], device="cpu"), C64)


def test_fft2d_transposed_output(world):
    r = res(world, "fft2d_transposed_output")
    assert r["y"].shape == (32, 16)
    gate(r["y"], np.fft.fft2(r["x"].astype(np.complex128)).T, C64)
    assert r["placements"] == [S0, S0]


def test_fft2d_roundtrip(world):
    r = res(world, "fft2d_roundtrip")
    gate(r["back"], r["x"], C64)


def test_fft2d_batch_dims_and_complex_api(world):
    r = res(world, "fft2d_batch_dims_and_complex_api")
    x = r["x"]
    gate(r["y"], np.fft.fft2(x.astype(np.complex128), axes=(-2, -1)), C64)
    gate(r["y"], tft.fft2(x, device="cpu"), C64)
    gate(r["back"], x, C64)


@pytest.mark.parametrize("chunks", [2, 4])
def test_fft2d_pipelined_equivalence(world, chunks):
    r = res(world, f"fft2d_pipelined[{chunks}]")
    assert np.array_equal(r["base"], r["piped"])
    assert np.array_equal(r["tbase"], r["tpiped"])


def test_fft2d_dtensor_in_and_out(world):
    """The counterpart of passing a plan through jit: DTensors in give
    DTensors out with the JAX out_specs, and results flow from plan to plan
    without a whole array."""
    r = res(world, "fft2d_dtensor_in_and_out")
    assert set(r["types"]) == {"DTensor"}
    gate(r["y"], np.fft.fft2(r["x"].astype(np.complex128)), C64)
    gate(r["back"], r["x"], C64)
    gate(r["tt"], r["x"], C64)
    assert r["placements"] == [["Shard(dim=1)"]] * 4


@pytest.mark.parametrize("backend", ["native", "dd"])
def test_fft2d_c128(world, backend):
    r = res(world, f"fft2d_c128[{backend}]")
    gate(r["y"], np.fft.fft2(r["x"]), C128)
    gate(r["y"], tft.fft2(r["x"], device="cpu"), C128)
    gate(r["back"], r["x"], C128)


def test_dd_names_not_ported():
    """The 4-plane double-word API stays in the reference (ROADMAP.md queue
    1 item 7): c128 runs native f64 through the same calls."""
    assert sorted(parallel.__all__) == sorted([
        "Fft2dPlan", "Fft3dPlan", "FourStepPlan", "Rfft2dPlan", "Rfft3dPlan",
        "batched_transform", "batched_rfft", "batched_irfft"])
    for name in ("batched_transform_dd", "batched_rfft_dd", "batched_irfft_dd"):
        assert not hasattr(parallel, name)
    for cls in (parallel.FourStepPlan, parallel.Fft2dPlan, parallel.Fft3dPlan):
        assert not hasattr(cls, "transform_planar_dd") and issubclass(cls, torch.nn.Module)
    assert tft.parallel is parallel


# -- Fft3dPlan ----------------------------------------------------------------


@pytest.mark.parametrize("dims", ["8x8x8", "4x8x16"])
@pytest.mark.parametrize("mode", ["FFT", "IFFT"])
def test_fft3d_pencil_vs_numpy(world, dims, mode):
    r = res(world, f"fft3d_pencil[{dims}-{mode}]")
    x = r["x"]
    np_fn, port_fn = (np.fft.fftn, tft.fftn) if mode == "FFT" else (np.fft.ifftn, tft.ifftn)
    gate(r["y"], np_fn(x.astype(np.complex128)), C64)
    gate(r["y"], port_fn(x, device="cpu"), C64)


def test_fft3d_spectral_layout_roundtrip(world):
    r = res(world, "fft3d_spectral_roundtrip")
    gate(r["ys"], r["yn"], C64)  # the same logical spectrum
    gate(r["ys"], np.fft.fftn(r["x"].astype(np.complex128)), C64)
    gate(r["back"], r["x"], C64)
    assert r["placements"] == [SPECTRAL3, SPECTRAL3, NATURAL3, NATURAL3]


@pytest.mark.parametrize("mesh", ["fft", "pq"])
def test_fft3d_slab_one_mesh_axis(world, mesh):
    r = res(world, f"fft3d_slab_one_mesh_axis[{mesh}]")
    gate(r["y"], np.fft.fftn(r["x"].astype(np.complex128)), C64)
    gate(r["back"], r["x"], C64)


def test_fft3d_batch_dims_and_planar_api(world):
    r = res(world, "fft3d_batch_dims_and_planar_api")
    x = r["x"]
    gate(r["y"], np.fft.fftn(x.astype(np.complex128), axes=(-3, -2, -1)), C64)
    gate(r["y"], tft.fftn(x, 3, device="cpu"), C64)
    gate(r["back"], x, C64)
    assert r["placements"] == [["Shard(dim=1)", "Shard(dim=2)"]] * 2


@pytest.mark.parametrize("backend", ["native", "dd"])
def test_fft3d_c128(world, backend):
    r = res(world, f"fft3d_c128[{backend}]")
    gate(r["y"], np.fft.fftn(r["x"]), C128)
    gate(r["back"], r["x"], C128)


@pytest.mark.parametrize("chunks", [2, 4])
def test_fft3d_pipelined_equivalence(world, chunks):
    r = res(world, f"fft3d_pipelined[{chunks}]")
    for k in ("0", "1"):
        assert np.array_equal(r["base" + k], r["piped" + k])
    assert np.array_equal(r["back_base"], r["back_piped"])
    gate(r["piped1"], np.fft.fftn(r["x"].astype(np.complex128)), C64)
    gate(r["back_piped"], r["x"], C64)


# -- Rfft3dPlan ---------------------------------------------------------------


@pytest.mark.parametrize("dims", ["8x8x16", "4x8x9"])
def test_rfft3d_pencil_vs_numpy(world, dims):
    r = res(world, f"rfft3d_pencil[{dims}]")
    x = r["x"]
    want = np.fft.rfftn(x.astype(np.float64))
    assert r["y"].shape == want.shape
    gate(r["y"], want, RFFT)
    gate(r["y"], tft.rfftn(x, device="cpu"), RFFT)
    gate(r["back"], x, RFFT)


def test_rfft3d_planar_pad_contract(world):
    """The planar spectrum carries the pad tail, exactly zero."""
    r = res(world, "rfft3d_planar_pad_contract")
    assert r["n"] == (9, 10)
    assert r["re"].shape == (8, 8, 10)
    assert np.all(r["re"][..., 9:] == 0) and np.all(r["im"][..., 9:] == 0)
    gate(r["re"][..., :9] + 1j * r["im"][..., :9], np.fft.rfftn(r["x"].astype(np.float64)),
         RFFT)
    gate(r["back"], r["x"], RFFT)
    assert r["placements"] == [NATURAL3] * 3


def test_rfft3d_spectral_layout_roundtrip(world):
    r = res(world, "rfft3d_spectral_roundtrip")
    gate(r["y"][..., :r["out_len"]], np.fft.rfftn(r["x"].astype(np.float64)), RFFT)
    gate(r["back"], r["x"], RFFT)
    assert r["placements"] == [SPECTRAL3, SPECTRAL3, NATURAL3]


@pytest.mark.parametrize("mesh", ["fft", "pq"])
def test_rfft3d_slab_and_batch_dims(world, mesh):
    r = res(world, f"rfft3d_slab_and_batch_dims[{mesh}]")
    assert r["n"] == ((6, 6) if mesh == "fft" else (6, 8))
    want = np.fft.rfftn(r["x"].astype(np.float64), axes=(-3, -2, -1))
    gate(r["y"], want, RFFT)
    gate(r["y"], tft.rfftn(r["x"], 3, device="cpu"), RFFT)
    gate(r["back"], r["x"], RFFT)


@pytest.mark.parametrize("backend", ["native", "dd"])
def test_rfft3d_c128(world, backend):
    r = res(world, f"rfft3d_c128[{backend}]")
    gate(r["y"], np.fft.rfftn(r["x"]), C128)
    gate(r["back"], r["x"], C128)


@pytest.mark.parametrize("chunks", [2, 4])
def test_rfft3d_pipelined_equivalence(world, chunks):
    r = res(world, f"rfft3d_pipelined[{chunks}]")
    for k in ("0", "1"):
        assert np.array_equal(r["base" + k], r["piped" + k])
        assert np.array_equal(r["back_base" + k], r["back_piped" + k])
        gate(r["back_piped" + k], r["x"], RFFT)


def test_spectral_layout_halves_exchanges(world):
    """The counterpart of test_spectral_layout_halves_collectives_in_hlo: the
    exchange helper's count over a filter round trip."""
    assert res(world, "spectral_layout_halves_exchanges") == {"natural": 8, "spectral": 4}


# -- Rfft2dPlan ---------------------------------------------------------------


@pytest.mark.parametrize("n2", [32, 21])
def test_rfft2d_vs_numpy(world, n2):
    r = res(world, f"rfft2d[{n2}]")
    x = r["x"]
    want = np.fft.rfft2(x.astype(np.float64))
    gate(r["y"], want, RFFT)
    gate(r["y"], tft.rfft2(x, device="cpu"), RFFT)
    gate(r["back"], x, RFFT)
    assert r["n"] == (n2 // 2 + 1, 4 * -(-(n2 // 2 + 1) // 4))
    assert r["placements"] == [S0] * 3


def test_rfft2d_transposed_roundtrip_and_batch(world):
    r = res(world, "rfft2d_transposed_roundtrip_and_batch")
    x = r["x"]
    assert r["y"].shape == (3, r["n2p"], 16)  # transposed layout
    want = np.fft.rfft2(x.astype(np.float64), axes=(-2, -1))
    gate(np.swapaxes(r["y"], -1, -2)[..., :17], want, RFFT)
    gate(r["rfft"], want, RFFT)
    gate(r["back"], x, RFFT)
    assert r["placements"] == [["Shard(dim=1)"]] * 3


@pytest.mark.parametrize("backend", ["native", "dd"])
def test_rfft2d_c128(world, backend):
    r = res(world, f"rfft2d_c128[{backend}]")
    gate(r["y"], np.fft.rfft2(r["x"]), C128)
    gate(r["back"], r["x"], C128)


# -- the card's routes, files, summaries, layout ---------------------------------


def test_card_routes(world):
    r = res(world, "card_routes")
    gate(r["fft2d"], np.fft.fft2(r["fft2d_x"].astype(np.complex128)), C64)
    gate(r["four"], np.fft.fft(r["four_x"].astype(np.complex128)), C64)
    for n2 in (128, 769):
        x = r[f"rfft2d{n2}_x"]
        gate(r[f"rfft2d{n2}"], np.fft.rfft2(x.astype(np.float64)), RFFT)
        gate(r[f"rfft2d{n2}_back"], x, RFFT)
        assert r[f"fused{n2}"]
    gate(r["dd"], np.fft.fft2(r["dd_x"]), C128)
    gate(r["rfft3d"], np.fft.rfftn(r["rfft3d_x"].astype(np.float64)), RFFT)
    gate(r["rfft3d_back"], r["rfft3d_x"], RFFT)


VALIDATION = {
    "four_step_n1": ("ValueError", "n1=9 and n2=16 must both be divisible by mesh axis size 4"),
    "fft2d_n2": ("ValueError", "must both be divisible by mesh axis size 4"),
    "fft2d_chunks": ("ValueError", "pipeline_chunks=3 must divide the local shard extent 4"),
    "four_step_chunks0": ("ValueError", "pipeline_chunks must be >= 1, got 0"),
    "fft3d_n0": ("ValueError", "n0=7 and n1=8 must both be divisible by mesh axis 'x' size 2"),
    "fft3d_n2": ("ValueError", "n1=8 and n2=6 must both be divisible by mesh axis 'q' size 4"),
    "fft3d_axes": ("ValueError", "axes must name 1 (slab) or 2 (pencil) mesh axes"),
    "fft3d_names": ("KeyError", "mesh has no dim 'x'"),
    "fft3d_chunks0": ("ValueError", "pipeline_chunks must be >= 1, got 0"),
    "rfft3d_n0": ("ValueError", "n0=7 and n1=8 must both be divisible"),
    "rfft3d_n1": ("ValueError", "n1=6 must be divisible by mesh axis 'q' size 4"),
    "rfft3d_axes": ("ValueError", "axes must name 1 (slab) or 2 (pencil) mesh axes"),
    "rfft2d_n1": ("ValueError", "n1=6 must be divisible by mesh axis 'fft' size 4"),
    "rfft3d_shape": ("ValueError", "trailing axes (8, 8, 12)"),
    "rfft3d_pad_tail": ("ValueError", "the planar spectrum carries the pad tail"),
    "fft2d_shape": ("ValueError", "trailing axes (16, 8) do not match plan shape (16, 16)"),
    "fft2d_placements": ("ValueError", "differ from the plan's"),
    "rfft2d_pad_tail": ("ValueError", "planar spectra carry the pad tail"),
}
# The batch-sharded calls on 6 rows over 4 ranks, as tensors and as uneven
# Shard(0) DTensors: shard_map's refusal, not rows dropped.
UNEVEN = ("ValueError", "array axis 0 (of size {rows}) maps to mesh axis 'batch' "
          "(of size {world}), but {world} does not evenly divide {rows}")
BATCHED = [f"batched_{call}_uneven{kind}" for call in ("transform", "rfft", "irfft")
           for kind in ("", "_dtensor")]
VALIDATION.update({k: (UNEVEN[0], UNEVEN[1].format(rows=6, world=4)) for k in BATCHED})


@pytest.mark.parametrize("what", sorted(VALIDATION))
def test_validation_errors(world, what):
    """The JAX package's errors, with its messages."""
    got = res(world, "validation")[what]
    kind, msg = VALIDATION[what]
    assert got is not None, f"{what} raised nothing"
    assert got[0] == kind and msg in got[1], got


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    """A 3-rank world: the odd size at which a batch of 10 rows is uneven."""
    return world_cases.run_world(tmp_path_factory.mktemp("gloo3"), ["three_ranks"],
                                 world=3)["three_ranks"]


@pytest.mark.parametrize("what", BATCHED)
def test_three_ranks_refuse_ten_rows(world3, what):
    if "error" in world3:
        pytest.fail(world3["error"])
    got = world3[what]
    assert got is not None, f"{what} raised nothing"
    assert got[0] == UNEVEN[0] and UNEVEN[1].format(rows=10, world=3) in got[1], got


@pytest.mark.parametrize("call", ["transform", "rfft", "irfft"])
def test_three_ranks_nine_rows_match_single(world3, call):
    if "error" in world3:
        pytest.fail(world3["error"])
    x = world3["x"]
    if call == "transform":
        z = (x + 1j * x[:, ::-1]).astype(np.complex64)
        want = cpu_plan(x.shape[-1]).fft(z)
    else:
        rplan = tft.RfftPlan(x.shape[-1], np.complex64, device="cpu")
        spec = np.fft.rfft(x.astype(np.float64)).astype(np.complex64)
        want = rplan.rfft(x) if call == "rfft" else rplan.irfft(spec)
    got = world3[call]
    assert got.shape == (9,) + tuple(np.shape(want))[1:]
    gate(got, np.asarray(want), C64 if call == "transform" else RFFT)


def test_plans_are_modules(world):
    """nn.Modules owning their sub-plans and tables (the pytree's place);
    the four-step's split twiddle holds this rank's columns, cast from f64."""
    r = res(world, "plans_are_modules")
    want = {"four": (["col_plan", "row_plan"], ["tw_fwd", "tw_inv"]),
            "fft2d": (["col_plan"], []),  # n1 == n2: one owned plan serves both
            "fft3d": (["plan0", "plan2"], []),
            "rfft2d": (["col_plan", "rplan"], []),
            "rfft3d": (["plan0", "rplan"], [])}
    for k, (subs, tables) in want.items():
        got = r[k]
        assert got["module"] and got["mesh"], k
        assert got["subplans"] == subs, (k, got["subplans"])
        assert [b for b in got["buffers"] if "." not in b] == tables, k
    k1 = np.arange(16.0)[:, None]
    j2 = np.arange(8.0)[None, :]  # rank 0's columns of n2 = 32
    theta = 2 * np.pi * k1 * j2 / 512
    assert r["tw_shape"] == (2, 16, 8)
    assert np.array_equal(r["tw_local"], np.stack([np.cos(theta), -np.sin(theta)]).astype(
        np.float32))


@pytest.mark.parametrize("kind", ["fft2d", "four", "fft3d", "rfft2d", "rfft3d"])
def test_serialize_roundtrip(world, kind):
    """save_plan/load_plan and plan_to_bytes: the mesh rebound, buffers and
    outputs bitwise; no mesh or another mesh refused with the JAX errors."""
    r = res(world, "serialize_roundtrip")
    got = r[kind]
    assert got == {"type": got["type"], "mesh": True, "buffers": True, "repr": True,
                   "bitwise": True}
    assert r["missing_mesh"][0] == "ValueError" and "pass load_plan(..., mesh=...)" in \
        r["missing_mesh"][1] and "['fft'] of shape [4]" in r["missing_mesh"][1]
    for key in ("wrong_mesh", "wrong_shape"):
        assert r[key][0] == "ValueError" and "does not match the plan's mesh" in r[key][1]


def test_summaries(world):
    """describe/summarize: the JAX package's kinds and cost model, the
    exchange named for its transport (gloo here)."""
    r = res(world, "summaries")
    kinds = {"FourStepPlan": "FourStepSharded", "Fft2dPlan": "Fft2dSharded",
             "Rfft2dPlan": "Rfft2dSharded", "Fft3dPlan": "Fft3dPencil",
             "Rfft3dPlan": "Rfft3dPencil"}
    for name, kind in kinds.items():
        s = r[name]
        assert s["kind"] == kind and s["describe"].startswith(kind)
        assert any("(GLOO" in st or "GLOO)" in st for st in s["stages"]), s["stages"]
        assert not any("ICI" in st for st in s["stages"])
    col = tft.summarize(cpu_plan(32)).flops_per_transform
    row = tft.summarize(cpu_plan(16)).flops_per_transform
    assert r["Fft2dPlan"]["flops"] == 32 * row + 16 * col
    assert r["Fft2dPlan"]["bytes"] == 2 * 512 * 8
    assert "2 overlapped chunks" in r["Fft2dPlan"]["stages"][1]
    assert r["Rfft3dPlan"]["stages"][-1] == "n0 FFTs (8-point)"  # spectral: no restore
    assert r["Rfft2dPlan"]["children"] == ["RealFft", "Stockham"]


LAYOUTS = ["fft2d", "fft2d_chunked", "fft2d_transposed", "four_step", "fft3d",
           "fft3d_from_spectral", "rfft2d", "irfft2d", "rfft3d", "irfft3d", "batched"]


@pytest.mark.parametrize("call", LAYOUTS)
def test_copies_per_leg(world, call):
    """Every leg copies each element at most once (into the batch-minor
    layout its kernel takes: contiguous (n, B)); between an exchange and
    the next one, or the result, at most once too."""
    r = res(world, "copies_per_leg")[call]
    assert "K" in r["events"]
    assert max(r["segments"]) <= r["data"], r
    for method, size, shapes in r["kernels"]:
        for shape, contiguous in shapes:
            lead = size // 2 + 1 if method == "irfft_planar_bm" else size
            assert contiguous and len(shape) == 2 and shape[0] == lead, (method, shape)
