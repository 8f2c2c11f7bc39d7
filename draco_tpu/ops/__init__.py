"""Numerics layer: batched device kernels for the analysis/synthesis tasks.

Replaces the reference's CPU numerics stack — FFTW, LAPACK via scipy,
healpy/cora SHTs, the OpenMP Cython kernels of ``draco/util/_fast_tools.pyx``
(see SURVEY.md section 2.4) — with XLA-compiled batched kernels: jnp FFTs,
``jax.lax.linalg``, a native HEALPix spherical-harmonic transform built from
stabilised Legendre recurrences + matmuls.
"""
