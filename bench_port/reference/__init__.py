"""Plain PyTorch references of the benchmark's configurations, in fp32 with
TF32 off. They import neither JAX nor anything of the program."""
