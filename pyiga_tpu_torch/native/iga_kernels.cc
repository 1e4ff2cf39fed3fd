// Native host-side kernels of pyiga_tpu_torch (the Gauss-Seidel sweeps and
// the rank-1 update of pyiga_tpu/native/iga_kernels.cc).
//
// Gauss-Seidel relaxation is strictly sequential, and its update order is
// part of the numerical contract: the iteration counts of the local
// multigrid solver's host path depend on the exact sweep order.  Compiled
// with g++ at first use and loaded via ctypes; a numpy fallback exists for
// every entry point.

#include <cstdint>
#include <cstddef>

extern "C" {

// Forward/backward Gauss-Seidel sweep on a CSR matrix.
// Sweeps rows [start, end) with the given step (+1 or -1 semantics via
// start/end/step), updating x in place.
void gauss_seidel_csr(const int64_t* indptr, const int64_t* indices,
                      const double* data, double* x, const double* b,
                      int64_t start, int64_t end, int64_t step) {
    for (int64_t i = start; i != end; i += step) {
        double diag = 0.0, z = 0.0;
        for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
            const int64_t j = indices[k];
            if (j == i)
                diag = data[k];
            else
                z += data[k] * x[j];
        }
        if (diag != 0.0)            // zero/missing diagonal: skip the row
            x[i] = (b[i] - z) / diag;
    }
}

// Gauss-Seidel sweep restricted to a subset of rows, in the order given
// (or reversed).  This is the local multigrid smoother.
void gauss_seidel_csr_indexed(const int64_t* indptr, const int64_t* indices,
                              const double* data, double* x, const double* b,
                              const int64_t* rows, int64_t nrows,
                              int reverse) {
    for (int64_t n = 0; n < nrows; ++n) {
        const int64_t i = rows[reverse ? (nrows - 1 - n) : n];
        double diag = 0.0, z = 0.0;
        for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
            const int64_t j = indices[k];
            if (j == i)
                diag = data[k];
            else
                z += data[k] * x[j];
        }
        if (diag != 0.0)            // zero/missing diagonal: skip the row
            x[i] = (b[i] - z) / diag;
    }
}

// Rank-1 update  A += alpha * x y^T  on a row-major (m x n) matrix, the
// cross update of the 2D ACA.  Single-threaded on purpose: BLAS threading
// costs more than it gives for one small update.
void rank_1_update(double* A, int64_t m, int64_t n, double alpha,
                   const double* x, const double* y) {
    for (int64_t i = 0; i < m; ++i) {
        double axi = alpha * x[i];
        double* row = A + i * n;
        for (int64_t j = 0; j < n; ++j)
            row[j] += axi * y[j];
    }
}

}  // extern "C"
