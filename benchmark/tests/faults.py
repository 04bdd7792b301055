"""Faults planted under the timed path, for the tests that see ``correct``
come out false. Each takes the driver (after set-up) and breaks its timed
entry; module-level, so that spawned ranks can take them."""

from __future__ import annotations

import torch


def _planes(y):
    return y if isinstance(y, tuple) else (y,)


def unchanged(driver) -> None:
    """A call that returns its input unchanged."""
    driver.entry = lambda x, forward: x


def half_batch(driver) -> None:
    """A call that transforms half the batch and leaves the rest as it was."""
    inner, dim = driver.entry, driver.batch_dim

    def call(x, forward):
        y = inner(x, forward)
        for py, px in zip(_planes(y), _planes(x)):
            half = py.shape[dim] // 2
            py.narrow(dim, half, py.shape[dim] - half).copy_(
                px.narrow(dim, half, px.shape[dim] - half))
        return y
    driver.entry = call


def altered(driver) -> None:
    """A call whose answer is altered where it is produced: one value of
    every output moved by one."""
    inner = driver.entry

    def call(x, forward):
        y = inner(x, forward)
        p = _planes(y)[0]
        p[(0,) * p.ndim] += 1.0
        return y
    driver.entry = call


def forward_as_inverse(driver) -> None:
    """The forward transform computed where the inverse is asked for (a
    twiddle's sign lost)."""
    inner = driver.entry
    driver.entry = lambda x, forward: inner(x, True)


def _reversed(t, dims):
    for d in dims:
        t = torch.roll(torch.flip(t, [d]), 1, d)
    return t


def reversed_inverse(driver) -> None:
    """An inverse whose output index k holds the answer of index -k mod n
    along each transform axis."""
    inner, dims = driver.entry, driver.answer_dims

    def call(x, forward):
        y = inner(x, forward)
        if forward:
            return y
        return tuple(_reversed(q, dims) for q in y) if isinstance(y, tuple) else _reversed(y, dims)
    driver.entry = call
