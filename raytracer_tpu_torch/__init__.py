"""PyTorch + CUDA port of the ``raytracer_tpu`` path tracer.

Plain tensor code is PyTorch; the fused bounce step is a hand-written CUDA
kernel for Hopper (``csrc/bounce.cu``), built with ``nvcc`` at first use
(``kernels/build.py``). The package imports neither ``jax`` nor
``raytracer_tpu``; the JAX package is the reference it is tested against.
"""
