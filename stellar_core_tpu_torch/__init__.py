"""stellar_core_tpu_torch: the PyTorch/CUDA port of `stellar_core_tpu`.

Module paths mirror the JAX package's. Imports torch, numpy and the
standard library only; never `jax`, never `stellar_core_tpu`. See README.md
("The PyTorch/CUDA port") for what is ported so far.
"""
