// Host-side assembly for quantumpropagators_torch (a copy of the JAX
// package's native/qprop_native.cpp; the port builds its own so that it
// never reaches into the JAX package).
//
// What stays on the host is the runtime work the reference delegates to
// Julia's SparseArrays/SuiteSparse stack (reference
// src/generators.jl:473-524 kron assembly, test/optomech.jl):
// assembling large sparse Hamiltonians, converting layouts, and
// partitioning rows/halos for the device mesh.  For 2^20..2^24-dimension
// lattice models, scipy.sparse kron assembly is minutes/GBs; these
// direct CSR generators are O(nnz) with small constants.
//
// Exposed via a plain C ABI for ctypes; built with g++ at first use by
// quantumpropagators_torch/native.py.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <complex>
#include <vector>
#include <thread>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Transverse-field Ising chain:  H = J Σ σz_i σz_{i+1} + h Σ σz_i + g Σ σx_i
// CSR over the 2^L computational basis; site 0 = most significant bit.
// Row i has: 1 diagonal entry + L off-diagonal entries (bit flips).
// Returns nnz written.  Arrays must be preallocated:
//   indptr: (2^L + 1) int64;  cols: ((L+1)*2^L) int64;
//   vals_re/vals_im: ((L+1)*2^L) double
// ---------------------------------------------------------------------------
int64_t tfim_chain_csr(
    int32_t L, double J, double g, double h, int32_t periodic,
    int64_t* indptr, int64_t* cols, double* vals_re, double* vals_im)
{
    const int64_t N = int64_t(1) << L;
    const int64_t row_nnz = L + 1;
    const int n_threads = std::max(1u, std::thread::hardware_concurrency());
    std::vector<std::thread> threads;
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            // diagonal: J * sum_z s_k s_{k+1} + h * sum_z s_k
            double diag = 0.0;
            double s_prev = 0.0;
            for (int32_t k = 0; k < L; ++k) {
                const double s = ((i >> (L - 1 - k)) & 1) ? -1.0 : 1.0;
                if (k > 0) diag += J * s_prev * s;
                diag += h * s;
                s_prev = s;
            }
            if (periodic) {
                const double s0 = ((i >> (L - 1)) & 1) ? -1.0 : 1.0;
                diag += J * s_prev * s0;
            }
            int64_t base = i * row_nnz;
            // entries must be sorted by column: collect flip targets
            // (i ^ bit) plus the diagonal, in ascending column order.
            int64_t tmp_cols[65];
            int32_t n = 0;
            for (int32_t k = 0; k < L; ++k)
                tmp_cols[n++] = i ^ (int64_t(1) << k);
            tmp_cols[n++] = i;
            std::sort(tmp_cols, tmp_cols + n);
            for (int32_t k = 0; k < n; ++k) {
                cols[base + k] = tmp_cols[k];
                if (tmp_cols[k] == i) {
                    vals_re[base + k] = diag;
                    vals_im[base + k] = 0.0;
                } else {
                    vals_re[base + k] = g;
                    vals_im[base + k] = 0.0;
                }
            }
            indptr[i] = base;
        }
    };
    const int64_t chunk = (N + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * chunk, hi = std::min(N, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
    indptr[N] = N * row_nnz;
    return N * row_nnz;
}

// ---------------------------------------------------------------------------
// 2D transverse-field Ising on an Lx x Ly lattice (open boundaries):
//   H = J Σ_<ij> σz_i σz_j + h Σ σz_i + g Σ σx_i
// Site (x, y) = bit (Lx*Ly - 1 - (x*Ly + y)).
// Row nnz = Lx*Ly + 1.
// ---------------------------------------------------------------------------
int64_t tfim_lattice2d_csr(
    int32_t Lx, int32_t Ly, double J, double g, double h,
    int64_t* indptr, int64_t* cols, double* vals_re, double* vals_im)
{
    const int32_t L = Lx * Ly;
    const int64_t N = int64_t(1) << L;
    const int64_t row_nnz = L + 1;
    const int n_threads = std::max(1u, std::thread::hardware_concurrency());
    std::vector<std::thread> threads;
    auto spin = [L](int64_t i, int32_t site) -> double {
        return ((i >> (L - 1 - site)) & 1) ? -1.0 : 1.0;
    };
    auto work = [&](int64_t lo, int64_t hi) {
        std::vector<int64_t> tmp_cols(row_nnz);
        for (int64_t i = lo; i < hi; ++i) {
            double diag = 0.0;
            for (int32_t x = 0; x < Lx; ++x) {
                for (int32_t y = 0; y < Ly; ++y) {
                    const int32_t s = x * Ly + y;
                    const double sv = spin(i, s);
                    diag += h * sv;
                    if (x + 1 < Lx) diag += J * sv * spin(i, (x + 1) * Ly + y);
                    if (y + 1 < Ly) diag += J * sv * spin(i, x * Ly + y + 1);
                }
            }
            int64_t base = i * row_nnz;
            int32_t n = 0;
            for (int32_t k = 0; k < L; ++k)
                tmp_cols[n++] = i ^ (int64_t(1) << k);
            tmp_cols[n++] = i;
            std::sort(tmp_cols.begin(), tmp_cols.begin() + n);
            for (int32_t k = 0; k < n; ++k) {
                cols[base + k] = tmp_cols[k];
                vals_re[base + k] = (tmp_cols[k] == i) ? diag : g;
                vals_im[base + k] = 0.0;
            }
            indptr[i] = base;
        }
    };
    const int64_t chunk = (N + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * chunk, hi = std::min(N, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
    indptr[N] = N * row_nnz;
    return N * row_nnz;
}

// ---------------------------------------------------------------------------
// Multithreaded complex CSR SpMV (reference-style CPU baseline and
// host-side verification at scales where scipy is too slow).
//   y = A x, complex double split into re/im planes.
// ---------------------------------------------------------------------------
void csr_spmv_z(
    int64_t n_rows, const int64_t* indptr, const int64_t* cols,
    const double* a_re, const double* a_im,
    const double* x_re, const double* x_im,
    double* y_re, double* y_im)
{
    const int n_threads = std::max(1u, std::thread::hardware_concurrency());
    std::vector<std::thread> threads;
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            double sr = 0.0, si = 0.0;
            for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
                const int64_t j = cols[k];
                const double ar = a_re[k], ai = a_im[k];
                const double xr = x_re[j], xi = x_im[j];
                sr += ar * xr - ai * xi;
                si += ar * xi + ai * xr;
            }
            y_re[i] = sr;
            y_im[i] = si;
        }
    };
    const int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * chunk, hi = std::min(n_rows, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Row-block partition metadata for the device mesh: for each device
// block of n_local rows, compute the required left/right halo width
// (max distance of any referenced column outside the block) and remap
// column indices into the extended-local frame [0, 2w + n_local).
// Returns the halo width, or -1 if any column falls outside the
// nearest-neighbor halo (caller falls back to all-gather).
// ---------------------------------------------------------------------------
int64_t csr_band_partition_remap(
    int64_t n_rows, int64_t n_devices,
    const int64_t* indptr, const int64_t* cols,
    int64_t* ext_cols /* out, same length as cols */)
{
    const int64_t n_local = n_rows / n_devices;
    // pass 1: measure halo
    int64_t w = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        const int64_t lo = (i / n_local) * n_local;
        for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
            const int64_t c = cols[k];
            if (c < lo) w = std::max(w, lo - c);
            else if (c >= lo + n_local) w = std::max(w, c - (lo + n_local - 1));
        }
    }
    if (w > n_local) return -1;
    // pass 2: remap
    for (int64_t i = 0; i < n_rows; ++i) {
        const int64_t lo = (i / n_local) * n_local;
        for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k)
            ext_cols[k] = cols[k] - (lo - w);
    }
    return w;
}

}  // extern "C"
