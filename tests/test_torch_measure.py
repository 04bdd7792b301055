"""Measured planning and wisdom (``fourier_tpu_torch.plan.measure``) against
the JAX package's (``fourier_tpu.plan.measure``).

Counterparts of ``tests/test_measure.py``'s six tests on the same numpy
inputs. Off the card one family alone is eligible, so the CPU plans
``stockham`` without timing at c64 and c128 both (the JAX package times
its XLA double-word family against the f64 Stockham on the CPU; the port's
counterpart, ``DdFftPlan``, is the same f64 plan there); ``_time_plan`` is
held on a CPU plan, the card's candidate lists without building them, a
document the JAX package exported imports here, and an entry naming
``dd_xla`` rebuilds a ``DdFftPlan``. Gates: rel-L2 <= 1e-6 (c64) and <= 1e-12 (c128)
against np.fft and the JAX package's measured plan.
"""

import json

import numpy as np
import pytest
import torch

import fourier_tpu as jft
from fourier_tpu.plan import measure as jmeasure

import fourier_tpu_torch as tft
from fourier_tpu_torch import Transform
from fourier_tpu_torch.plan import AutosortPlan, BluesteinPlan, measure


@pytest.fixture(autouse=True)
def _fresh_wisdom():
    measure.forget_wisdom()
    jmeasure.forget_wisdom()
    yield
    measure.forget_wisdom()
    jmeasure.forget_wisdom()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    return torch.device("cuda", 0)


def _rand(shape, seed, dtype=np.complex64):
    return (np.random.default_rng(seed).standard_normal(shape)
            + 1j * np.random.default_rng(seed + 1).standard_normal(shape)).astype(dtype)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _fft_via(plan, x):
    re, im = plan.fft_planar(torch.as_tensor(x.real.copy()), torch.as_tensor(x.imag.copy()))
    return re.numpy() + 1j * im.numpy()


@pytest.mark.parametrize("n,dtype", [(96, np.complex64), (32, np.complex128),
                                     (73, np.complex128)])
def test_measure_cpu_single_candidate_no_timing(n, dtype):
    """c64 and c128 on the CPU: the Stockham family alone, not timed; the
    plan against np.fft and the JAX package's measured plan."""
    res = tft.measure_fft(n, dtype, device="cpu")
    assert res.best == "stockham" and res.platform == "cpu"
    assert res.timings_us == {"stockham": 0.0}  # sole candidate: not timed
    assert isinstance(res.plan, (AutosortPlan, BluesteinPlan))
    x = _rand(n, 0, dtype)
    got = _fft_via(res.plan, x)
    gate = 1e-6 if dtype == np.complex64 else 1e-12
    assert _rel(got, np.fft.fft(x.astype(np.complex128))) <= gate
    # Either family the JAX timer picks (c128: stockham or dd_xla) has .fft.
    jplan = jft.measure_fft(n, dtype, batch=8, chain=2, iters=1).plan
    assert _rel(got, np.asarray(jplan.fft(x))) <= gate


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_time_plan_on_a_cpu_plan(dtype):
    """The timing core (the suite's) on a CPU plan: a positive time per
    transform, chained through the batch-major call (AutosortPlan has no
    batch-minor path of its own) and the batch-minor one (BluesteinPlan)."""
    for n in (32, 37):
        plan = tft.create_fft(n, dtype, device="cpu", cache=False)
        sec = measure._time_plan(plan, n, batch=8, chain=2, iters=1)
        assert sec > 0 and np.isfinite(sec)


def test_card_candidates():
    """The families timed on the card, listed without building a plan."""
    cuda = torch.device("cuda", 0)
    assert [l for l, _ in measure._candidates(4096, torch.complex64, cuda)] == \
        ["vpu", "mxu", "stockham"]
    assert [l for l, _ in measure._candidates(1024, torch.complex128, cuda)] == \
        ["dd", "dd_xla"]
    cpu = torch.device("cpu")
    for dtype in (torch.complex64, torch.complex128):
        assert [l for l, _ in measure._candidates(64, dtype, cpu)] == ["stockham"]


def test_create_fft_backend_measure():
    plan = tft.create_fft(64, np.complex64, backend="measure", device="cpu", cache=False)
    x = _rand(64, 4)
    want = np.fft.fft(x.astype(np.complex128))
    assert _rel(_fft_via(plan, x), want) <= 1e-6
    # the second creation reads the wisdom (no measurement): poison measure_fft
    orig = measure.measure_fft
    measure.measure_fft = None
    try:
        plan2 = tft.create_fft(64, np.complex64, backend="measure", device="cpu", cache=False)
    finally:
        measure.measure_fft = orig
    assert _rel(_fft_via(plan2, x), want) <= 1e-6


def test_wisdom_export_import_roundtrip(tmp_path):
    tft.measure_fft(96, np.complex64, device="cpu")
    doc = tft.export_wisdom()
    parsed = json.loads(doc)
    assert parsed["version"] == measure.WISDOM_VERSION
    assert list(parsed["entries"]) == ["cpu/complex64/96"]
    entry = parsed["entries"]["cpu/complex64/96"]
    assert set(entry) == {"backend", "timings_us", "batch", "chain"}
    path = tmp_path / "wisdom.json"
    tft.export_wisdom(str(path))
    tft.forget_wisdom()
    assert measure.plan_from_wisdom(96, np.complex64, device="cpu") is None
    assert tft.import_wisdom(str(path)) == 1
    assert measure.plan_from_wisdom(96, np.complex64, device="cpu") is not None
    tft.forget_wisdom()
    assert tft.import_wisdom(doc) == 1


def test_jax_wisdom_imports():
    """A document the JAX package exported imports here; its entries keep
    their keys, a tpu/... entry among them, which no CPU (or card) plan
    reads."""
    jft.measure_fft(96, np.complex64)
    doc = json.loads(jft.export_wisdom())
    doc["entries"]["tpu/complex64/4096"] = {"backend": "vpu", "timings_us": {"vpu": 1.0},
                                            "batch": 4096, "chain": 32}
    assert tft.import_wisdom(json.dumps(doc)) == 2
    assert set(json.loads(tft.export_wisdom())["entries"]) == {
        "cpu/complex64/96", "tpu/complex64/4096"}
    plan = measure.plan_from_wisdom(96, np.complex64, device="cpu")
    assert isinstance(plan, AutosortPlan)
    assert measure.plan_from_wisdom(4096, np.complex64, device="cpu") is None


def test_wisdom_rejects_malformed():
    with pytest.raises(ValueError):
        tft.import_wisdom("{not json")
    with pytest.raises(ValueError):
        tft.import_wisdom(json.dumps({"version": 999, "entries": {}}))
    with pytest.raises(ValueError):
        tft.import_wisdom(json.dumps({
            "version": measure.WISDOM_VERSION,
            "entries": {"cpu/complex64/64": {"backend": "evil_pickle"}},
        }))
    with pytest.raises(ValueError, match="malformed"):
        tft.import_wisdom(json.dumps({
            "version": measure.WISDOM_VERSION,
            "entries": {"cpu/complex64": {"backend": "stockham"}},
        }))
    assert json.loads(tft.export_wisdom())["entries"] == {}


def test_dd_xla_wisdom_imports():
    """An entry naming the JAX package's dd_xla (its double-word XLA
    DdFftPlan) imports, and rebuilds the port's DdFftPlan: the f64 Stockham
    at 64, a Bluestein at 73, each against np.fft."""
    from fourier_tpu_torch.precision import DdFftPlan

    entry = {"backend": "dd_xla", "timings_us": {"dd_xla": 1.0}, "batch": 8, "chain": 8}
    assert tft.import_wisdom(json.dumps({
        "version": measure.WISDOM_VERSION,
        "entries": {f"cpu/complex128/{n}": entry for n in (64, 73)}})) == 2
    for n, kind in ((64, "stockham"), (73, "bluestein")):
        plan = measure.plan_from_wisdom(n, np.complex128, device="cpu")
        assert isinstance(plan, DdFftPlan) and plan.kind == kind
        x = _rand((3, n), n, np.complex128)
        assert _rel(_fft_via(plan, x), np.fft.fft(x)) <= 1e-12


def test_measured_plan_modes_roundtrip():
    res = tft.measure_fft(48, np.complex64, device="cpu")
    x = _rand((4, 48), 6)
    fre, fim = res.plan.transform_planar(torch.as_tensor(x.real.copy()),
                                         torch.as_tensor(x.imag.copy()), Transform.FFT)
    bre, bim = res.plan.transform_planar(fre, fim, Transform.IFFT)
    assert _rel(bre.numpy() + 1j * bim.numpy(), x) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype", [(4096, torch.complex64), (1024, torch.complex128)])
def test_measure_on_card(cuda_device, n, dtype):
    """On the card every family is timed and the winner remembered, with
    the card's name."""
    res = tft.measure_fft(n, dtype, device=cuda_device)
    assert set(res.timings_us) == ({"vpu", "mxu", "stockham"} if dtype == torch.complex64
                                   else {"dd", "dd_xla"})
    assert all(v > 0 for v in res.timings_us.values())
    entry = json.loads(tft.export_wisdom())["entries"][f"cuda/{str(dtype)[6:]}/{n}"]
    assert entry["backend"] == res.best and entry["device_name"]
