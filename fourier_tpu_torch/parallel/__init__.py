from fourier_tpu_torch.parallel.sharded import (
    Fft2dPlan,
    Fft3dPlan,
    FourStepPlan,
    Rfft2dPlan,
    Rfft3dPlan,
    batched_irfft,
    batched_irfft_dd,
    batched_rfft,
    batched_rfft_dd,
    batched_transform,
    batched_transform_dd,
)

__all__ = [
    "Fft2dPlan",
    "Fft3dPlan",
    "FourStepPlan",
    "Rfft2dPlan",
    "Rfft3dPlan",
    "batched_irfft",
    "batched_irfft_dd",
    "batched_rfft",
    "batched_rfft_dd",
    "batched_transform",
    "batched_transform_dd",
]
