"""Device operations of the port: basis tables, geometry fields,
sum-factorization assembly with its CUDA kernels, the generated
coefficient-field kernels of variational forms, the flat banded and
compact multilevel matvecs, Dirichlet restriction and the
fast-diagonalization preconditioners."""
