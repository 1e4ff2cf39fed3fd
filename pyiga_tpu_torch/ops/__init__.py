"""Device operations of the port: basis tables, geometry fields,
sum-factorization assembly with its CUDA kernels, the generated
coefficient-field kernels of variational forms, the flat banded and
compact multilevel matvecs, Dirichlet restriction, the
fast-diagonalization preconditioners, and the local-multigrid solve with
its order-exact wavefront Gauss-Seidel smoother."""
