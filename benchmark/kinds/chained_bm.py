"""Dependent chains of batch-minor 1-D calls through a plan.

Mix parameters: ``n``, ``batch``, ``modes`` (a transform mode and its
inverse), and those of :mod:`benchmark.chains`. The timed entry:
``create_fft_f32(n).transform_planar_bm(re, im, mode)`` on (n, batch)
float32 planes, the first mode on even calls of a chain and its inverse on
odd ones. The reference computes the first mode of each kept input in
float64 and judges every transform (column) of every call kept.
"""

from __future__ import annotations

import torch

from benchmark import work
from benchmark.chains import Chains
from benchmark.reference import dft as ref
from benchmark.sample import device_seed


def work_of(config: dict, traffic: dict, world: int = 1) -> work.Work:
    """One call: `batch` transforms of `n` points."""
    return work.batched(int(traffic["n"]), int(traffic["batch"]), config["dtype"])


class Driver(Chains):
    def __init__(self, ctx):
        import fourier_tpu_torch as ftt
        from fourier_tpu_torch.transform import Transform

        super().__init__(ctx)
        t = ctx.traffic
        self.n, self.batch = int(t["n"]), int(t["batch"])
        self.modes = [Transform[m] for m in t["modes"]]
        if len(self.modes) != 2 or self.modes[1] != self.modes[0].inverse():
            raise ValueError("modes are a transform mode and its inverse")
        self.plan = ftt.create_fft_f32(self.n, device=ctx.device)
        g = torch.Generator(device=ctx.device).manual_seed(device_seed(ctx.seed))
        x = torch.randn((self.n_inputs, 2, self.n, self.batch), generator=g, device=ctx.device)
        self.inputs = [(x[p, 0], x[p, 1]) for p in range(self.n_inputs)]
        self.batch_dim, self.answer_dims = 1, (0,)
        self.work = work_of(ctx.config, t)

    def entry(self, x, forward: bool):
        """The timed entry: one call on planes x = (re, im)."""
        return self.plan.transform_planar_bm(*x, self.modes[0 if forward else 1])

    def reference_entry(self, precision: str):
        """The reference in the entry's place (the control: "tf32")."""
        def call(x, forward):
            mode = self.modes[0 if forward else 1]
            return ref.dft(*x, 0, mode.is_forward, mode.scale(self.n) or 1.0, precision)
        return call

    def release(self) -> None:
        self.plan = self.entry = None

    def check(self) -> dict:
        mode, errs = self.modes[0], []
        for p in self.kept_inputs():
            x = self.inputs[p]
            want = ref.dft(*x, 0, mode.is_forward, mode.scale(self.n) or 1.0)
            errs += self.compare(p, want, x, (0,))
            del want
        return {"rel_l2_worst": torch.cat(errs).tolist()}
