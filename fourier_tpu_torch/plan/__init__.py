from fourier_tpu_torch.plan.aot import CompiledFft, export_compiled, load_compiled
from fourier_tpu_torch.plan.autosort import AutosortPlan
from fourier_tpu_torch.plan.base import FftPlan
from fourier_tpu_torch.plan.bluestein import BluesteinPlan
from fourier_tpu_torch.plan.bluestein_fused import VpuBluesteinPlan
from fourier_tpu_torch.plan.convert import load_jax_plan
from fourier_tpu_torch.plan.four_step_local import FourStepLocalPlan
from fourier_tpu_torch.plan.measure import (MeasureResult, export_wisdom, forget_wisdom,
                                            import_wisdom, measure_fft)
from fourier_tpu_torch.plan.mxu import MxuFftPlan
from fourier_tpu_torch.plan.factor import RADICES, factorize_autosort, next_power_of_two
from fourier_tpu_torch.plan.planner import (
    clear_plan_cache,
    create_fft,
    create_fft_f32,
    create_fft_f64,
    plan_tree,
)
from fourier_tpu_torch.plan.serialize import load_plan, plan_to_bytes, save_plan
from fourier_tpu_torch.plan.vpu import VpuFftPlan
from fourier_tpu_torch.precision import (DdFftPlan, DdMxuDirectPlan, DdSplitPow2Plan,
                                         DdSplitRadixPlan, VpuDdBluesteinPlan,
                                         VpuDdFftPlan)

__all__ = [
    "AutosortPlan",
    "BluesteinPlan",
    "CompiledFft",
    "DdFftPlan",
    "DdMxuDirectPlan",
    "DdSplitPow2Plan",
    "DdSplitRadixPlan",
    "FftPlan",
    "FourStepLocalPlan",
    "MeasureResult",
    "MxuFftPlan",
    "RADICES",
    "VpuBluesteinPlan",
    "VpuDdBluesteinPlan",
    "VpuDdFftPlan",
    "VpuFftPlan",
    "clear_plan_cache",
    "create_fft",
    "create_fft_f32",
    "create_fft_f64",
    "export_compiled",
    "export_wisdom",
    "factorize_autosort",
    "forget_wisdom",
    "import_wisdom",
    "load_compiled",
    "load_jax_plan",
    "load_plan",
    "measure_fft",
    "next_power_of_two",
    "plan_to_bytes",
    "plan_tree",
    "save_plan",
]
