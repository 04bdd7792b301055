#!/usr/bin/env python3
"""Differential gate: the native C++ planner against the port's plan-time math.

Runs the ``dump_plan`` tool for sizes covering every plan family (pure
pow2, pow3, composite with 5, prime: Stockham and Bluestein) and both
dtypes, parses the dumped schedule and tables, and rebuilds them with the
port's own plan-time functions (``fourier_tpu_torch.plan.factor``'s
``factorize_autosort`` and ``next_power_of_two``,
``fourier_tpu_torch.twiddle.stage_twiddles``,
``fourier_tpu_torch.plan.bluestein._chirp_tables``). Any disagreement on
schedule, inner size, table shapes or table values fails: the two planners
share semantics by contract (both mirror the reference's
``autosort/mod.rs:104-134`` and ``bluesteins.rs:18-61``).

    python -m fourier_tpu_torch.ffi.plan_parity [dump_plan binary]

Without an argument it builds ``dump_plan`` (:mod:`fourier_tpu_torch.ffi.build`).
Exit codes: 0 pass, 1 mismatch, 77 the port's planner cannot be imported
(ctest's skip), 2 usage.
"""

from __future__ import annotations

import subprocess
import sys

SIZES = [64, 73, 100, 243, 1013]
# Stage-table tolerance and the Bluestein w tables' (FFTs of the chirp).
DTYPES = {"f32": ("float32", 4e-7, 2e-5), "f64": ("float64", 4e-15, 1e-12)}


def parse_dump(text: str) -> dict:
    """Parse dump_plan's output into a nested dict."""
    import numpy as np

    lines = iter(text.splitlines())

    def parse_plan():
        head = next(lines).split()
        if head[0] != "plan":
            raise ValueError(f"expected a plan line, got {head}")
        plan = {"kind": head[1], "tables": {}}
        while True:
            parts = next(lines).split()
            if parts[0] == "end":
                return plan
            if parts[0] in ("size", "inner_size"):
                plan[parts[0]] = int(parts[1])
            elif parts[0] == "radices":
                plan["radices"] = tuple(int(r) for r in parts[1:])
            elif parts[0] == "table":
                vals = np.empty(int(parts[2]), dtype=np.complex128)
                for i in range(vals.size):
                    re, im = next(lines).split()
                    vals[i] = complex(float(re), float(im))
                plan["tables"][parts[1]] = vals
            elif parts[0] == "inner":
                plan["inner"] = parse_plan()
            else:
                raise ValueError(f"unexpected dump line: {parts}")

    return parse_plan()


def _narrow(table, real_dtype):
    import numpy as np

    table = np.asarray(table)
    return (table.real.astype(real_dtype).astype(np.float64)
            + 1j * table.imag.astype(real_dtype).astype(np.float64))


def expected_stockham_tables(size, radices, real_dtype):
    """The port's stage tables, narrowed to the dtype, flattened in dump order."""
    import numpy as np

    from fourier_tpu_torch.twiddle import stage_twiddles

    fwd, inv = [], []
    for r in radices:
        fwd.append(_narrow(stage_twiddles(size, r, True), real_dtype).reshape(-1))
        inv.append(_narrow(stage_twiddles(size, r, False), real_dtype).reshape(-1))
        size //= r
    return np.concatenate(fwd), np.concatenate(inv)


def check_table(label, got, want, atol) -> list:
    import numpy as np

    if got.shape != want.shape:
        return [f"{label}: shape {got.shape} != {want.shape}"]
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    if err > atol * scale:
        return [f"{label}: max |diff| {err:.3e} > {atol:.1e} * {scale:.3e}"]
    return []


def check_size(dump_bin, size: int, dkey: str) -> list:
    """The mismatches between dump_plan's plan of `size` and the port's."""
    from fourier_tpu_torch.plan.bluestein import _chirp_tables
    from fourier_tpu_torch.plan.factor import factorize_autosort, next_power_of_two

    real_dtype, tw_tol, w_tol = DTYPES[dkey]
    out = subprocess.run([str(dump_bin), str(size), dkey], capture_output=True,
                         text=True, check=True)
    plan = parse_dump(out.stdout)
    radices = factorize_autosort(size)
    if radices is not None:
        if plan["kind"] != "stockham":
            return [f"n={size}: native kind {plan['kind']}, the port's stockham"]
        if plan["radices"] != tuple(radices):
            return [f"n={size}: schedule {plan['radices']} != the port's {tuple(radices)}"]
        fwd, inv = expected_stockham_tables(size, radices, real_dtype)
        return (check_table(f"n={size}/{dkey} fwd_tw", plan["tables"]["fwd_tw"], fwd,
                            tw_tol)
                + check_table(f"n={size}/{dkey} inv_tw", plan["tables"]["inv_tw"], inv,
                              tw_tol))
    if plan["kind"] != "bluestein":
        return [f"n={size}: native kind {plan['kind']}, the port's bluestein"]
    m = next_power_of_two(2 * size - 1)
    errors = []
    if plan["inner_size"] != m:
        errors.append(f"n={size}: inner size {plan['inner_size']} != the port's {m}")
    w_fwd, w_inv, x_fwd, x_inv = _chirp_tables(size, m)
    # Chirp angles reach pi*n (theta = pi*j^2/n), so libm-vs-numpy argument
    # reduction differs by about n*eps: the x tables' tolerance grows with n.
    x_tol = tw_tol * max(1.0, float(size))
    for name, want, tol in (("x_fwd", _narrow(x_fwd, real_dtype), x_tol),
                            ("x_inv", _narrow(x_inv, real_dtype), x_tol),
                            ("w_fwd", w_fwd, w_tol), ("w_inv", w_inv, w_tol)):
        errors += check_table(f"n={size}/{dkey} {name}", plan["tables"][name],
                              want, tol)
    inner_radices = factorize_autosort(m)
    if plan["inner"]["radices"] != tuple(inner_radices):
        errors.append(f"n={size}: inner schedule {plan['inner']['radices']} != "
                      f"the port's {tuple(inner_radices)}")
    fwd, _ = expected_stockham_tables(m, inner_radices, real_dtype)
    errors += check_table(f"n={size}/{dkey} inner fwd_tw",
                          plan["inner"]["tables"]["fwd_tw"], fwd, tw_tol)
    return errors


def run(dump_bin) -> list:
    """Every mismatch over SIZES x DTYPES (empty: parity holds)."""
    return [e for size in SIZES for dkey in DTYPES for e in check_size(dump_bin, size, dkey)]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) > 1:
        print("usage: python -m fourier_tpu_torch.ffi.plan_parity [dump_plan binary]")
        return 2
    try:
        import numpy  # noqa: F401

        import fourier_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"SKIP: cannot import the port's planner ({e})")
        return 77
    if argv:
        dump_bin = argv[0]
    else:
        from fourier_tpu_torch.ffi.build import build_dump_plan

        dump_bin = build_dump_plan()
    failures = run(dump_bin)
    if failures:
        print("PLAN PARITY FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print(f"plan parity OK: sizes {SIZES} x dtypes {list(DTYPES)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
