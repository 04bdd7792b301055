"""Dependent chains of batch-minor 1-D calls at several sizes a round.

Mix parameters: ``sizes`` and ``batches`` (one batch a size, in the order
of a round), ``modes`` (a transform mode and its inverse), and those of
:mod:`benchmark.chains`. A call of the cell is one round: at each size in
order, one call of the timed entry
``create_fft_f32(n).transform_planar_bm(re, im, mode)`` on that size's (n,
batch) float32 planes, from that size's last output. A chain is ``chain``
rounds, the first mode on even rounds and its inverse on odd ones, so every
size runs the chain of :mod:`benchmark.chains` on its own. The reference
computes the first mode of each kept input at each size in float64 and
judges every transform (column) of every size of every round kept.
"""

from __future__ import annotations

import torch

from benchmark import work
from benchmark.chains import Chains
from benchmark.reference import dft as ref
from benchmark.sample import device_seed


def rows(traffic: dict):
    """(n, batch) of each size of a round, in order."""
    sizes, batches = traffic["sizes"], traffic["batches"]
    if len(sizes) != len(batches) or len(set(sizes)) != len(sizes):
        raise ValueError("one batch a size, and each size once a round")
    return [(int(n), int(b)) for n, b in zip(sizes, batches)]


def work_of(config: dict, traffic: dict, world: int = 1) -> work.Work:
    """One call (a round): at each size, `batch` transforms of `n` points."""
    parts = [work.batched(n, b, config["dtype"]) for n, b in rows(traffic)]
    return work.Work(sum(p.flops for p in parts), sum(p.bytes for p in parts))


class Driver(Chains):
    def __init__(self, ctx):
        import fourier_tpu_torch as ftt
        from fourier_tpu_torch.transform import Transform

        super().__init__(ctx)
        t = ctx.traffic
        self.rows = rows(t)
        self.modes = [Transform[m] for m in t["modes"]]
        if len(self.modes) != 2 or self.modes[1] != self.modes[0].inverse():
            raise ValueError("modes are a transform mode and its inverse")
        self.plans = {n: ftt.create_fft_f32(n, device=ctx.device) for n, _ in self.rows}
        for p in range(self.n_inputs):
            planes = []
            for i, (n, b) in enumerate(self.rows):
                g = torch.Generator(device=ctx.device).manual_seed(device_seed(ctx.seed, p, i))
                x = torch.randn((2, n, b), generator=g, device=ctx.device)
                planes.append((x[0], x[1]))
            self.inputs.append(tuple(planes))
        self.batch_dim, self.answer_dims = 1, (0,)
        self.work = work_of(ctx.config, t)

    def entry(self, x, forward: bool):
        """The timed entry: one call on one size's planes x = (re, im),
        through the plan of its size."""
        return self.plans[x[0].shape[0]].transform_planar_bm(*x, self.modes[0 if forward else 1])

    def reference_entry(self, precision: str):
        """The reference in the entry's place (the control: "tf32")."""
        def call(x, forward):
            n, mode = x[0].shape[0], self.modes[0 if forward else 1]
            return ref.dft(*x, 0, mode.is_forward, mode.scale(n) or 1.0, precision)
        return call

    def step(self) -> None:
        """One chain of rounds, from the next input: each size of a round
        from its own output of the round before."""
        p = self.chains % self.n_inputs
        self.chains += 1
        slot = self.kept.slot()
        xs, outs = self.inputs[p], []
        for i in range(self.chain):
            xs = tuple(self.entry(x, i % 2 == 0) for x in xs)
            if slot is not None:
                outs.append(xs)
        self.calls += self.chain
        if slot is not None:
            self.kept.items[slot] = (p, outs)

    def release(self) -> None:
        self.plans = self.entry = None

    def check(self) -> dict:
        mode, errs = self.modes[0], []
        for p in self.kept_inputs():
            for i, (n, _) in enumerate(self.rows):
                x = self.inputs[p][i]
                want = ref.dft(*x, 0, mode.is_forward, mode.scale(n) or 1.0)
                errs += self.compare(p, want, x, (0,), lambda y, i=i: y[i])
                del want
        return {"rel_l2_worst": torch.cat(errs).tolist()}
