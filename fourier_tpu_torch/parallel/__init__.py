from fourier_tpu_torch.parallel.sharded import (
    Fft2dPlan,
    Fft3dPlan,
    FourStepPlan,
    Rfft2dPlan,
    Rfft3dPlan,
    batched_irfft,
    batched_rfft,
    batched_transform,
)

__all__ = [
    "Fft2dPlan",
    "Fft3dPlan",
    "FourStepPlan",
    "Rfft2dPlan",
    "Rfft3dPlan",
    "batched_irfft",
    "batched_rfft",
    "batched_transform",
]
