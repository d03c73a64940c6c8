"""Plain PyTorch references of the benchmark's configurations: float32
(TF32 off) or a float8 control, no kernels, nothing of the program."""
