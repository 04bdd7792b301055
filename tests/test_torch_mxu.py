"""The port's MXU family (DFT products) against the JAX package.

* ``ops/dft_matrix.py``: every table bitwise equal to the JAX package's.
* ``MxuFftPlan`` (``impl="xla"``): the port and the JAX plan on the same
  seeded inputs, all 5 modes, rel-L2 <= 2e-6 (``tests/test_mxu.py``'s gate);
  single-phase, direct and two-phase folded splits.
* Every impl (``"xla"``, ``"xla_packed"``, ``"pallas"``: kernels B9a/B9b,
  their plain versions on the CPU, the JAX kernels in interpret mode) at
  the sizes ``chip_smoke.py`` checks the kernels at: equal splits and impl,
  all 5 modes, both layouts; ``tb=4`` with an odd batch.
* The products run in full float32 whatever the caller's TF32 setting, and
  the caller's setting is restored afterwards.
"""

import numpy as np
import pytest
import torch

import fourier_tpu as jft
from fourier_tpu import Transform as JTransform
from fourier_tpu.ops import dft_matrix as jdm
from fourier_tpu.plan.mxu import MxuFftPlan as JMxuFftPlan

import fourier_tpu_torch as tft
from fourier_tpu_torch import Transform
from fourier_tpu_torch.ops import bailey
from fourier_tpu_torch.ops import dft_matrix as dm
from fourier_tpu_torch.plan import MxuFftPlan

RNG_SEED = 0x3A7
REL_L2 = 2e-6


def _rand(shape, rng):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("n", [1, 7, 64, 100, 128, 222, 439, 2048, 4096, 10007,
                               16384, 16385])
def test_dft_tables_bitwise_equal_jax(n):
    assert dm.choose_split(n) == jdm.choose_split(n)
    if n > 512:
        return
    for fwd in (True, False):
        np.testing.assert_array_equal(dm.dft_matrix(n, fwd), jdm.dft_matrix(n, fwd))
    n1, n2 = jdm.choose_split(n) or (1, n)
    for fwd in (True, False):
        np.testing.assert_array_equal(dm.split_twiddle(n1, n2, fwd),
                                      jdm.split_twiddle(n1, n2, fwd))
        np.testing.assert_array_equal(dm.folded_phase_b(n1, n2, fwd, 0.5),
                                      jdm.folded_phase_b(n1, n2, fwd, 0.5))


@pytest.mark.parametrize("n,split", [(32, (1, 32)), (125, (1, 125)),
                                     (439, (1, 439)), (2048, (32, 64)),
                                     (4096, (64, 64))])
def test_mxu_plan_matches_jax(n, split):
    """The plan the mxu backend picks, in both packages, all 5 modes and both
    layouts; 439 is prime (the direct product past choose_split)."""
    mine = tft.create_fft(n, backend="mxu", cache=False, device="cpu")
    ref = jft.create_fft(n, backend="mxu", cache=False)
    assert isinstance(mine, MxuFftPlan) and isinstance(ref, JMxuFftPlan)
    assert (mine.n1, mine.n2) == (ref.n1, ref.n2) == split
    rng = np.random.default_rng(RNG_SEED + n)
    x = _rand((3, n), rng)
    for mode in Transform:
        got = mine.transform(x, mode)
        want = np.asarray(ref.transform(x, JTransform(int(mode))))
        assert got.shape == x.shape and got.dtype == np.complex64
        assert _rel(got, want) <= REL_L2, (n, mode)
        bre, bim = mine.transform_planar_bm(torch.as_tensor(x.real.T.copy()),
                                            torch.as_tensor(x.imag.T.copy()), mode)
        got = (bre.numpy() + 1j * bim.numpy()).T
        assert _rel(got, want) <= REL_L2, (n, mode, "bm")


@pytest.mark.parametrize("n", [222, 512, 625, 722, 2048, 4096])
def test_direct_single_phase_policy_matches_jax(n):
    """DIRECT_SINGLE_MAX flips small-factor composites to one full product,
    as in the JAX package."""
    mine = MxuFftPlan.create(n, device="cpu")
    ref = JMxuFftPlan.create(n)
    assert (mine.n1, mine.n2) == (ref.n1, ref.n2)
    assert mine.single_phase == (n <= MxuFftPlan.DIRECT_SINGLE_MAX)


def test_create_domain_and_unported_impls():
    assert MxuFftPlan.create(10007, device="cpu") is None  # prime > 128: no split
    assert MxuFftPlan.create(64, torch.complex128, device="cpu") is None
    assert MxuFftPlan.create_direct(64, torch.complex128, device="cpu") is None
    direct = MxuFftPlan.create_direct(1013, device="cpu")
    assert direct.single_phase and direct.size == 1013
    with pytest.raises(ValueError):
        MxuFftPlan.create(0, device="cpu")
    for impl in ("pallas", "xla_packed"):  # ported: kernel B9a at n <= 128
        plan = MxuFftPlan.create(64, impl=impl, device="cpu")
        assert plan.impl == impl and plan.single_phase and f"impl={impl}" in repr(plan)
    with pytest.raises(ValueError):
        MxuFftPlan.create(64, impl="bogus", device="cpu")


IMPL_SIZES = (1, 2, 7, 16, 64, 100, 125, 127, 128,  # B9a
              129, 243, 250, 384, 1000, 2048, 4096, 16129, 16384)  # B9b


@pytest.mark.parametrize("impl", ["xla", "xla_packed", "pallas"])
@pytest.mark.parametrize("n", IMPL_SIZES)
def test_mxu_impls_match_jax(n, impl):
    """MxuFftPlan.create(n, impl=...) in both packages: the same split (the
    direct single product only for "xla"), the same impl, all 5 modes and
    both layouts within rel-L2 2e-6."""
    mine = MxuFftPlan.create(n, impl=impl, device="cpu")
    ref = JMxuFftPlan.create(n, impl=impl)
    assert (mine.n1, mine.n2) == (ref.n1, ref.n2)
    assert mine.impl == ref.impl == impl and f"impl={impl}" in repr(ref)
    assert f"impl={impl}" in repr(mine)
    if impl != "xla":
        assert mine.single_phase == (n <= 128)
    rng = np.random.default_rng(RNG_SEED + n)
    x = _rand((3, n), rng)
    for mode in Transform:
        want = np.asarray(ref.transform(x, JTransform(int(mode))))
        got = mine.transform(x, mode)
        assert got.shape == x.shape and got.dtype == np.complex64
        assert _rel(got, want) <= REL_L2, (n, impl, mode)
        bre, bim = mine.transform_planar_bm(torch.as_tensor(x.real.T.copy()),
                                            torch.as_tensor(x.imag.T.copy()), mode)
        got = (bre.numpy() + 1j * bim.numpy()).T
        assert _rel(got, want) <= REL_L2, (n, impl, mode, "bm")


@pytest.mark.parametrize("n", [100, 256])
def test_pallas_tb_with_odd_batch(n):
    """tb=4 with B=7 (tests/test_mxu.py::test_mxu_odd_batch_padding): the
    JAX kernel pads the batch to the tile; the port's result is the same."""
    mine = MxuFftPlan.create(n, impl="pallas", tb=4, device="cpu")
    ref = JMxuFftPlan.create(n, impl="pallas", tb=4)
    assert mine.tb == ref.tb == 4 and "tb=4" in repr(mine)
    rng = np.random.default_rng(RNG_SEED)
    x = _rand((7, n), rng)
    for mode in (Transform.FFT, Transform.IFFT):
        got = mine.transform(x, mode)
        assert _rel(got, np.asarray(ref.transform(x, JTransform(int(mode))))) <= REL_L2
        want = np.fft.fft(x.astype(np.complex128)) if mode.is_forward else np.fft.ifft(
            x.astype(np.complex128))
        assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("n", [222, 250, 384, 625, 722, 1000])
def test_direct_switch_only_for_xla(n):
    """DIRECT_SINGLE_MAX flips small-factor splits to one product for
    impl="xla" only, as in the JAX package: a pallas or packed plan of 250
    stays (10, 25)."""
    for impl in ("xla_packed", "pallas"):
        mine = MxuFftPlan.create(n, impl=impl, device="cpu")
        ref = JMxuFftPlan.create(n, impl=impl)
        assert (mine.n1, mine.n2) == (ref.n1, ref.n2) == dm.choose_split(n)


_PRECISION_SETUPS = {
    "default": lambda: None,
    "legacy_allow_tf32": lambda: setattr(torch.backends.cuda.matmul, "allow_tf32", True),
    "legacy_precision": lambda: torch.set_float32_matmul_precision("high"),
    "new_api_matmul": lambda: setattr(torch.backends.cuda.matmul,
                                      "fp32_precision", "tf32"),
}


@pytest.mark.parametrize("setup", list(_PRECISION_SETUPS))
def test_full_f32_scope_forces_and_restores(setup):
    """Inside the scope cuBLAS may not use TF32; outside, the caller's setting
    is back as it was, whichever of PyTorch's APIs set it."""
    matmul = torch.backends.cuda.matmul
    if setup == "new_api_matmul" and getattr(matmul, "fp32_precision", None) is None:
        pytest.skip("this PyTorch has no per-backend fp32_precision API")
    before = (torch.get_float32_matmul_precision(),
              getattr(matmul, "fp32_precision", None))
    try:
        _PRECISION_SETUPS[setup]()
        caller = getattr(matmul, "fp32_precision", None)
        with bailey.full_f32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
        assert getattr(matmul, "fp32_precision", None) == caller
        if setup.startswith("legacy"):
            assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(before[0])
        if before[1] is not None:
            matmul.fp32_precision = before[1]


@pytest.mark.cuda
def test_mxu_sizes_pass_with_caller_tf32_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    rng = np.random.default_rng(RNG_SEED)
    before = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for n in (125, 439, 2048):
            plan = tft.create_fft(n, backend="mxu", device="cuda", cache=False)
            x = _rand((1000, n), rng)
            got = plan.fft(torch.as_tensor(x, device="cuda")).cpu().numpy()
            assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=-1)) <= 1e-6
            assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(before)
