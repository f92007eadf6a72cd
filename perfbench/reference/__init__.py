"""Plain float32 references of the benchmark's configurations, in PyTorch.

They import neither JAX, nor the JAX package, nor anything of the program,
and take nothing the program has made: the benchmark hands them its own
weights and inputs, and the program's outputs only to judge them.
"""
