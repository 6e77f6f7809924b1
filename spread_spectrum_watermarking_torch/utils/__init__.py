"""Host-side utilities: watermark storage, image I/O, debug helpers and the
reference's seeded marks. Copies of the JAX package's ``utils`` modules,
which the port cannot import (importing that package imports ``jax``)."""

__all__ = ["image_io", "storage", "debug", "rng_compat"]
