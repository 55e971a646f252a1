"""The plain reference: scenes built from the cell's inputs and a path
tracer, the SPPM final gather and one SPPM iteration in plain PyTorch,
float64 by default, on whichever device it is given. It imports nothing
of ``jax``, ``raytracer_tpu`` or ``raytracer_tpu_torch``, and takes
nothing the program made: where a comparison follows the program's own
SPPM state, the reference works every quantity out of that state again."""
