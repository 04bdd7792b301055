"""The plain reference: the discrete Fourier transform as products with its
matrix, in plain PyTorch. It imports nothing of the port and takes nothing
the port made; the benchmark hands it the same inputs it hands the port."""
