"""Synthesis (simulation) task library.

Re-provides the reference's ``draco/synthesis`` modules (stream, noise,
gain, mockcatalog — SURVEY.md section 2.2) on the device compute path:
batched SHT + beam-transfer einsums, JAX-PRNG noise/gain draws.
"""
