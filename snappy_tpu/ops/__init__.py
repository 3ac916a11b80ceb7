"""Device codec kernels (XLA array programs + the CUDA block decoder) and their selector."""
