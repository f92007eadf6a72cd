"""PyTorch port of the repro package for one NVIDIA H100.

Imports torch, never jax, and nothing from `repro`.  Entry points run on
the CUDA device unless the caller passes `device="cpu"`; on the CPU every
hand-written kernel is replaced by its plain torch version.
"""
