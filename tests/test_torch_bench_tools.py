"""The port's bench tools (``fourier_tpu_torch/tools``) against the JAX
package's (``fourier_tpu/tools``).

``bench_suite``: the same rows (families, sizes, batches, chain lengths) as
the JAX suite, ``default_batch`` equal at every suite n, and a CPU run of
one tiny family whose rows carry the JAX rows' keys (``fourier_tpu_*`` as
``fourier_tpu_torch_*``) plus ``torch_fft_*`` and ``plan_tree``, every
``rel_l2`` within its gate (1e-5 c64 and the round trips, 1e-12 c128), the
JSON file opening with the device record. ``prof``: two iterations on the
CPU, and a Chrome trace with ``--trace``. The chain lengths are cut for the
CPU run (the tools read them from their modules at call time).
"""

import json

import numpy as np
import pytest

from fourier_tpu.tools import bench_suite as jbs

from fourier_tpu_torch.tools import bench_suite as bs
from fourier_tpu_torch.tools import prof


def _rows(families):
    """(family, n, dtype) of every row of a suite's structure."""
    out = []
    for family, sizes in families.SIZE_FAMILIES.items():
        for n in sizes:
            for dkey in ("c64", "c128"):
                if family in families.C64_ONLY_FAMILIES and dkey != "c64":
                    continue
                out += [(family, n, dkey, d) for d in ("fft", "ifft")]
    return out + [("rfft", n, "f32/c64", "roundtrip") for n in families.RFFT_SIZES]


def test_same_rows_as_the_jax_suite():
    assert _rows(bs) == _rows(jbs) and len(_rows(bs)) == 67
    for name in ("CHAIN", "CHAIN_DD", "ITERS", "HOST_ITERS", "_HOST_ROW_CAP"):
        assert getattr(bs, name) == getattr(jbs, name), name


def test_default_batch_matches_jax():
    sizes = sorted({n for _, n, _, _ in _rows(jbs)})
    for n in sizes:
        assert bs.default_batch(n) == jbs.default_batch(n), n
    assert bs.default_batch(4096, base=1024) == jbs.default_batch(4096, base=1024)


@pytest.fixture
def short_chains(monkeypatch):
    for mod in (bs, jbs):
        monkeypatch.setattr(mod, "CHAIN", 2)
        monkeypatch.setattr(mod, "CHAIN_DD", 2)
        monkeypatch.setattr(mod, "ITERS", 1)
        monkeypatch.setattr(mod, "HOST_ITERS", 1)
    monkeypatch.setattr(jbs, "bench_native", lambda *a: None)  # no FFI build here


def test_run_on_cpu_rows(tmp_path, short_chains):
    path = tmp_path / "suite.json"
    rows = bs.run(batch=4, families=["pow2", "rfft"], max_sizes=1, dtypes=("c64", "c128"),
                  json_path=str(path), device="cpu")
    jrows = jbs.run(batch=4, families=["pow2", "rfft"], max_sizes=1, dtypes=("c64", "c128"))
    assert [(r["family"], r["n"], r["dtype"], r["direction"]) for r in rows] == \
        [(r["family"], r["n"], r["dtype"], r["direction"]) for r in jrows]
    extra = {"torch_fft_us", "torch_fft_gflops", "plan_tree"}
    for row, jrow in zip(rows, jrows):
        jkeys = {k.replace("fourier_tpu_", "fourier_tpu_torch_") for k in jrow}
        jkeys -= {"native_us", "native_gflops"}  # the JAX FFI column, where it built
        if jrow["family"] != "rfft":
            jkeys |= {"native_note"}
        assert set(row) == jkeys | extra, (set(row) ^ (jkeys | extra))
        assert row["fourier_tpu_torch_us"] > 0 and row["torch_fft_us"] > 0
        gate = 1e-12 if row["dtype"] == "c128" else 1e-5
        assert row["rel_l2"] <= gate, row
    doc = json.loads(path.read_text())
    assert list(doc) == ["device", "rows"] and doc["device"]["platform"] == "cpu"
    assert len(doc["rows"]) == len(rows) == 4 + 3
    assert rows[0]["native_note"] == bs.NATIVE_NOTE
    assert rows[0]["plan_tree"][0] == "AutosortPlan"


def test_cli_needs_a_card_unless_asked(tmp_path, short_chains):
    """The default device is the card: without one the CLI raises, and it
    falls back to nothing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bs.main(["--family", "pow2", "--max-sizes", "1", "--dtype", "c64"])
    rows = bs.main(["--family", "pow2", "--max-sizes", "1", "--dtype", "c64", "--batch", "2",
                    "--device", "cpu", "--json", str(tmp_path / "s.json")])
    assert len(rows) == 2


def test_prof_runs_on_cpu(capsys):
    prof.main(["--size", "64", "--batch", "4", "--iters", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "iter 2:" in out and "GFLOP/s" in out


def test_prof_writes_a_trace(tmp_path, capsys):
    prof.main(["--size", "64", "--batch", "4", "--iters", "2", "--device", "cpu",
               "--trace", str(tmp_path / "trace")])
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert "trace written to" in capsys.readouterr().out
