"""The complex128 route on native f64: the counterparts of the plan modules
of ``fourier_tpu/precision`` (``vpu_dd_plan``, ``dd_bluestein``,
``dd_split``). The double-word arithmetic they are built on in the JAX
package (``ddreal``, ``ddcplx``) has no counterpart: the card computes in
f64."""

from fourier_tpu_torch.precision.dd_bluestein import VpuDdBluesteinPlan
from fourier_tpu_torch.precision.dd_split import DdSplitPow2Plan, DdSplitRadixPlan
from fourier_tpu_torch.precision.vpu_dd_plan import VpuDdFftPlan

__all__ = ["DdSplitPow2Plan", "DdSplitRadixPlan", "VpuDdBluesteinPlan",
           "VpuDdFftPlan"]
