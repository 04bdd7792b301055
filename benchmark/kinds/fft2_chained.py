"""Dependent chains of 2-D calls through the numpy-compatible surface.

Mix parameters: ``group`` (images the reference takes at once) and those of
:mod:`benchmark.chains`; the configuration gives ``shape`` (n1, n2) and
``images_per_chip``. The timed entry: ``fourier_tpu_torch.fft2(x)`` on even
calls of a chain, ``ifft2`` on odd ones, on a complex64 (images, n1, n2)
tensor on the card. The reference computes the forward 2-D DFT of each kept
input in float64 and judges every image of every call kept (both axes and
the copies between them).
"""

from __future__ import annotations

import torch

from benchmark import work
from benchmark.chains import Chains
from benchmark.reference import dft as ref
from benchmark.sample import device_seed


def work_of(config: dict, traffic: dict, world: int = 1) -> work.Work:
    """One call: the configuration's images a card, 2-D transforms of
    n1·n2 points each."""
    n1, n2 = (int(v) for v in config["shape"])
    return work.batched(n1 * n2, int(config["images_per_chip"]) * world, config["dtype"])


class Driver(Chains):
    def __init__(self, ctx):
        import fourier_tpu_torch as ftt

        super().__init__(ctx)
        self.n1, self.n2 = (int(s) for s in ctx.config["shape"])
        self.images = int(ctx.config["images_per_chip"]) * ctx.world
        self.group = int(ctx.traffic["group"])
        self.ftt = ftt
        for p in range(self.n_inputs):
            g = torch.Generator(device=ctx.device).manual_seed(device_seed(ctx.seed, p))
            x = torch.randn((2, self.images, self.n1, self.n2), generator=g, device=ctx.device)
            self.inputs.append(torch.complex(x[0], x[1]))
            del x
        self.batch_dim, self.answer_dims = 0, (-2, -1)
        self.work = work_of(ctx.config, ctx.traffic, ctx.world)

    def entry(self, x, forward: bool):
        """The timed entry: one call on the complex tensor x."""
        return self.ftt.fft2(x) if forward else self.ftt.ifft2(x)

    def reference_entry(self, precision: str):
        """The reference in the entry's place (the control: "tf32")."""
        def call(x, forward):
            scale = 1.0 if forward else 1.0 / (self.n1 * self.n2)
            return torch.complex(*ref.dft2(x.real, x.imag, forward, scale, precision))
        return call

    def release(self) -> None:
        self.ftt = self.entry = None

    def check(self) -> dict:
        errs = []
        for p in self.kept_inputs():
            for i0 in range(0, self.images, self.group):
                sl = slice(i0, i0 + self.group)
                x = self.inputs[p][sl]
                want = ref.dft2(x.real, x.imag, True)
                errs += self.compare(p, want, (x.real, x.imag), (-2, -1),
                                     lambda y: (y[sl].real, y[sl].imag))
                del want
        return {"rel_l2_worst": torch.cat(errs).tolist()}
