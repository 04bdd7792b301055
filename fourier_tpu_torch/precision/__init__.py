"""The complex128 route on native f64: the counterparts of the modules of
``fourier_tpu/precision``. The plans (``vpu_dd_plan``, ``dd_bluestein``,
``dd_split``, ``dd_plan``, ``dd_mxu``) compute in f64 and keep the JAX
package's 4-plane double-word calls (``transform_planar_dd`` and the like,
``planes``: joined to f64 in, split to f32 pairs out). The double-word
arithmetic itself (``ddreal``, ``ddcplx``) is here for a caller's own dd
pipeline between two transforms, bitwise the JAX package's numpy path."""

from fourier_tpu_torch.precision.dd_bluestein import VpuDdBluesteinPlan
from fourier_tpu_torch.precision.dd_mxu import DdMxuDirectPlan
from fourier_tpu_torch.precision.dd_plan import DdFftPlan
from fourier_tpu_torch.precision.dd_split import DdSplitPow2Plan, DdSplitRadixPlan
from fourier_tpu_torch.precision.vpu_dd_plan import VpuDdFftPlan

__all__ = ["DdFftPlan", "DdMxuDirectPlan", "DdSplitPow2Plan", "DdSplitRadixPlan",
           "VpuDdBluesteinPlan", "VpuDdFftPlan"]
