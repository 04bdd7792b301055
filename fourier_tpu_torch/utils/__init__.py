from fourier_tpu_torch.utils.reference_dft import naive_dft, oracle_transform

__all__ = ["naive_dft", "oracle_transform"]
