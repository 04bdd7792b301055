"""Dependent chains of sharded 2-D calls through ``parallel.Fft2dPlan``.

Mix parameters: ``group`` (images the reference takes at once) and those of
:mod:`benchmark.chains`; the configuration gives ``shape`` (n1, n2),
``images_per_chip`` and ``pipeline_chunks``. The run's ranks form a 1-D
mesh ``"fft"``, one card a rank. The timed entry:
``Fft2dPlan(n1, n2, mesh, axis="fft", pipeline_chunks=C).transform_planar(re,
im, mode)`` on float32 DTensors (images, n1, n2) sharded by rows (spec
``(None, "fft", None)``), each built with ``DTensor.from_local`` from the
rank's own rows, as a deployment that holds its shard does, and handed back
as the rank's rows (``to_local``, no copy); ``FFT`` on even calls of a
chain, ``IFFT`` (1/N) on odd ones.

The images are ``images_per_chip`` times the world, each drawn from its own
seed (the run's seed, the input, the image's index), so every rank draws
its rows and its reference images alone, and the images do not depend on
the world's size. The reference is the float64 2-D DFT of each whole image
with only this rank's rows of the left DFT matrix: no exchange, no code of
the program. Every rank judges every image of every call it kept.
"""

from __future__ import annotations

import torch

from benchmark import work
from benchmark.chains import Chains
from benchmark.reference import dft as ref
from benchmark.sample import device_seed

AXIS = "fft"


def work_of(config: dict, traffic: dict, world: int = 1) -> work.Work:
    """This rank's share of one call: `images_per_chip` 2-D transforms of
    n1·n2 points, so that the ranks' shares add up to the call's work."""
    n1, n2 = (int(v) for v in config["shape"])
    return work.batched(n1 * n2, int(config["images_per_chip"]), config["dtype"])


class Driver(Chains):
    def __init__(self, ctx):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Shard

        from fourier_tpu_torch import parallel
        from fourier_tpu_torch.transform import Transform

        super().__init__(ctx)
        cfg = ctx.config
        self.n1, self.n2 = (int(s) for s in cfg["shape"])
        self.images = int(cfg["images_per_chip"]) * ctx.world
        self.group = int(ctx.traffic["group"])
        if self.n1 % ctx.world:
            raise ValueError(f"{self.n1} rows do not split over {ctx.world} ranks")
        self.rows = self.n1 // ctx.world
        self.mine = slice(ctx.rank * self.rows, (ctx.rank + 1) * self.rows)
        self.mesh = init_device_mesh(ctx.device.type, (ctx.world,), mesh_dim_names=(AXIS,))
        self.plan = parallel.Fft2dPlan(self.n1, self.n2, self.mesh, axis=AXIS,
                                       pipeline_chunks=int(cfg["pipeline_chunks"]))
        self.modes = (Transform.FFT, Transform.IFFT)
        self.shard = lambda t: DTensor.from_local(t, self.mesh, [Shard(1)], run_check=False)
        for p in range(self.n_inputs):
            re = torch.empty((self.images, self.rows, self.n2), device=ctx.device)
            im = torch.empty_like(re)
            for i in range(self.images):
                xr, xi = self.image(p, i)
                re[i], im[i] = xr[self.mine], xi[self.mine]
            self.inputs.append((re, im))
        self.batch_dim, self.answer_dims = 0, (-2, -1)
        self.work = work_of(cfg, ctx.traffic, ctx.world)

    def image(self, p: int, i: int):
        """The whole image `i` of input `p`, (re, im) planes (n1, n2)."""
        g = torch.Generator(device=self.ctx.device).manual_seed(device_seed(self.ctx.seed, p, i))
        x = torch.randn((2, self.n1, self.n2), generator=g, device=self.ctx.device)
        return x[0], x[1]

    def entry(self, x, forward: bool):
        """The timed entry: one call on this rank's rows x = (re, im), as
        row-sharded DTensors; this rank's rows of the result."""
        y = self.plan.transform_planar(*map(self.shard, x), self.modes[0 if forward else 1])
        return tuple(t.to_local() for t in y)

    def reference_entry(self, precision: str):
        """The reference in the entry's place (the control: "tf32"): each
        group of whole images gathered from the ranks' rows, this rank's
        rows of their 2-D DFT."""
        import torch.distributed as dist

        def whole(t):
            parts = [torch.empty_like(t) for _ in range(self.ctx.world)]
            dist.all_gather(parts, t.contiguous())
            return torch.cat(parts, dim=1)

        def call(x, forward):
            scale = 1.0 if forward else 1.0 / (self.n1 * self.n2)
            re, im = x
            out = [torch.empty_like(re), torch.empty_like(im)]
            for i0 in range(0, self.images, self.group):
                sl = slice(i0, i0 + self.group)
                yr, yi = ref.dft2(whole(re[sl]), whole(im[sl]), forward, scale, precision,
                                  self.mine)
                out[0][sl], out[1][sl] = yr, yi
            return tuple(out)
        return call

    def release(self) -> None:
        self.plan = self.entry = None

    def check(self) -> dict:
        errs = []
        for p in self.kept_inputs():
            given = self.inputs[p]
            for i0 in range(0, self.images, self.group):
                sl = slice(i0, i0 + self.group)
                whole = [self.image(p, i) for i in range(i0, min(i0 + self.group, self.images))]
                want = ref.dft2(torch.stack([w[0] for w in whole]),
                                torch.stack([w[1] for w in whole]), True, 1.0, "f64", self.mine)
                del whole
                errs += self.compare(p, want, tuple(g[sl] for g in given), (-2, -1),
                                     lambda y: (y[0][sl], y[1][sl]))
                del want
        return {"rel_l2_worst": torch.cat(errs).tolist()}
