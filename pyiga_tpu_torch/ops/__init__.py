"""Device operations of the port: basis tables, geometry fields,
sum-factorization assembly with its CUDA kernels, the flat banded matvec,
Dirichlet restriction and the fast-diagonalization preconditioner."""
