"""Analysis task library.

Re-provides the reference's ``draco/analysis`` modules (22 modules,
SURVEY.md section 2.3) on the device compute path: per-m/per-freq
Python loops become vmapped batched device kernels, MPI collectives become
mesh reshards.
"""
