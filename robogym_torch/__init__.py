"""robogym_torch: the PyTorch/CUDA port of robogym_tpu's physics.

The JAX package `robogym_tpu` stays the reference; this package imports
neither it nor JAX. Entry points take a `device` that defaults to "cuda";
on a CUDA tensor every kernel wrapper launches its hand-written Hopper
kernel, on a CPU tensor it runs the kernel's plain PyTorch version.
"""
