"""Dependent chains of a transform and its inverse: the loop that every
kind drives, and the check of the calls it keeps.

Mix parameters: ``chain`` (calls a chain, at least 2), ``inputs`` (seeded
inputs; chain i starts from input i mod `inputs`), ``keep`` (chains whose
every call the check judges, a uniform sample of the window's chains drawn
from the seed). Call i of a chain is the forward transform for even i and
its inverse for odd i, each reading the last call's output, so the exact
answer of an even call is the forward transform of the chain's input and
that of an odd call is the input itself. The check holds each call of each
kept chain against its own answer: the forward one against the reference,
the inverse one against the input. A forward call put in the inverse's
place, or an inverse that reverses its indices, fails the odd calls.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from benchmark.reference import dft as ref
from benchmark.sample import Reservoir, stream


class Chains:
    """The loop; a kind's ``Driver`` subclasses it and gives ``inputs``,
    ``entry(x, forward)`` and ``check()``, and may give ``keep_output``."""

    def __init__(self, ctx):
        t = ctx.traffic
        self.ctx = ctx
        self.chain, self.n_inputs = int(t["chain"]), int(t["inputs"])
        if self.chain < 2 or self.n_inputs < 1:
            raise ValueError("a chain holds a transform and its inverse, from one input or more")
        self.kept = Reservoir(t["keep"], stream(ctx.seed, "keep"))
        self.inputs: list = []
        self.calls = self.chains = 0

    def keep_output(self, y):
        """What the check keeps of a call's output."""
        return y

    def step(self) -> None:
        """One chain, from the next input."""
        p = self.chains % self.n_inputs
        self.chains += 1
        slot = self.kept.slot()
        x, outs = self.inputs[p], []
        for i in range(self.chain):
            x = self.entry(x, i % 2 == 0)
            if slot is not None:
                outs.append(self.keep_output(x))
        self.calls += self.chain
        if slot is not None:
            self.kept.items[slot] = (p, outs)

    def reset(self) -> None:
        """Zero the counts and the sample: what follows is measured."""
        self.calls = self.chains = 0
        self.kept.clear()

    def warm(self) -> None:
        """Every shape of the window, and as many chains kept as it keeps,
        so that the window's kept outputs take blocks the allocator holds."""
        for _ in range(max(2, self.kept.k)):
            self.step()
        self.ctx.sync()
        self.reset()

    def counters(self) -> dict:
        return {}

    def checked_calls(self) -> int:
        return sum(len(outs) for _, outs in self.kept.items)

    def kept_inputs(self) -> List[int]:
        return sorted({p for p, _ in self.kept.items})

    def compare(self, p: int, forward_ref: Tuple, given: Tuple, dims,
                part: Callable = lambda y: y) -> List[torch.Tensor]:
        """rel-L2 of `part` of every kept call from input `p`, one reading
        an answer: even calls against `forward_ref`, odd ones against the
        input `given`."""
        return [ref.rel_l2(part(y), forward_ref if i % 2 == 0 else given, dims)
                for q, outs in self.kept.items if q == p for i, y in enumerate(outs)]
