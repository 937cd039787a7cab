// Banded block SpMV for real block-banded operators on complex states
//
//     y[r*b + o] = sum_k sum_i planes[k, i, r, o] * x[(r + off_k)*b + i]
//
// the matvec of the reference-accuracy Chebyshev path for unstructured
// banded Hamiltonians (optomech/transmon kron chains, lattice
// discretizations, re-blocked BSR chains).  planes is float64 in the
// band-major layout (n_bands, b, R, b): for a fixed band k and input
// column i, the entries of all block rows r and outputs o are contiguous.
// x and y are interleaved complex128 (double2).  One launch is one
// complex matvec: every plane entry is read once and applied to both the
// real and the imaginary part.
//
// Window modes:
//   clamped (halo < 0): x has R block rows; rows r + off_k outside [0, R)
//     contribute zero and are never read.
//   halo-extended (halo = TR >= 0): x has R + 2*TR block rows (the local
//     rows with one TR-row halo each side, filled by the caller); output
//     row r reads x row r + TR + off_k.  The caller guarantees
//     |off_k| <= TR.
//
// Replaces the Pallas TPU kernel
//   quantumpropagators/ops/bsr_dd_pallas.py  _banded_apply_impl
//                                            (_banded_kernel)
// which emulated f64 with hi/lo f32 planes and Dekker products, tiled TR
// block rows through VMEM with clamped prev/cur/next windows, and ran
// once per real component (streaming the operator twice per complex
// matvec).  On Hopper f64 is native, the operator is read once per
// complex matvec, and the tile is simply the block row.
//
// Bound: memory.  The planes are 8 bytes per stored entry, read once;
// x is read once per band (b complex entries per block row and band,
// from L2 after the first band that touches it) and y written once.  At
// 2^20 with 3 dense 128-bands that is 3.22 GB of planes against 32 MB of
// state (x read, y written): 0.97 ms at 3.35 TB/s.  Arithmetic is 2 FMA
// per plane entry, 0.8 GFMA, far below the FP64 rate.
//
// Design: one thread block holds rpb = 128 / b block rows, one thread per
// output o of each row (b <= 128).  For each band the block stages its
// rows' x windows (b complex entries each, 2 KB at b = 128) in shared
// memory, then every thread walks i = 0..b-1 reading planes[k, i, r, o],
// coalesced over (r, o), with the loop unrolled so that several loads are
// in flight per thread.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxBands = 16;
constexpr int kMaxBlock = 128;
constexpr int kThreads = 128;

struct Offsets {
  int v[kMaxBands];
};

__global__ void __launch_bounds__(kThreads)
    banded_spmv(const double* __restrict__ planes,
                const double2* __restrict__ x, double2* __restrict__ y,
                Offsets offs, int n_bands, int64_t R, int b, int halo) {
  __shared__ double2 xs[kThreads];  // rpb * b <= kThreads entries
  const int o = threadIdx.x;
  const int64_t r = int64_t(blockIdx.x) * blockDim.y + threadIdx.y;
  const bool live = r < R;
  double2* xrow = xs + threadIdx.y * b;
  const int64_t plane_stride = R * b;  // from input column i to i + 1
  double acc_re = 0.0;
  double acc_im = 0.0;
  for (int k = 0; k < n_bands; ++k) {
    const int64_t c = halo >= 0 ? r + halo + offs.v[k] : r + offs.v[k];
    // every thread of a row agrees on `in`; all threads reach the barriers
    const bool in = live && (halo >= 0 || (c >= 0 && c < R));
    __syncthreads();  // the previous band's reads of xs are done
    if (in) xrow[o] = x[c * b + o];
    __syncthreads();
    if (in) {
      const double* p = planes + (int64_t(k) * b * R + r) * b + o;
#pragma unroll 8
      for (int i = 0; i < b; ++i) {
        const double a = p[int64_t(i) * plane_stride];
        const double2 xv = xrow[i];
        acc_re = fma(a, xv.x, acc_re);
        acc_im = fma(a, xv.y, acc_im);
      }
    }
  }
  if (live) y[r * b + o] = make_double2(acc_re, acc_im);
}

}  // namespace

// Plain C entry point for ctypes.  offsets is a host array of n_bands
// ints; halo < 0 selects the clamped mode.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int banded_spmv_f64(const void* planes, const void* x, void* y,
                               const int* offsets, int n_bands, int64_t R,
                               int b, int halo, void* stream) {
  if (n_bands < 0 || n_bands > kMaxBands || b < 1 || b > kMaxBlock || R < 1)
    return int(cudaErrorInvalidValue);
  Offsets offs = {};
  for (int k = 0; k < n_bands; ++k) offs.v[k] = offsets[k];
  const int rpb = kThreads / b;
  const int64_t blocks = (R + rpb - 1) / rpb;
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  banded_spmv<<<dim3(unsigned(blocks)), dim3(b, rpb), 0,
                (cudaStream_t)stream>>>(
      (const double*)planes, (const double2*)x, (double2*)y, offs, n_bands,
      R, b, halo);
  return int(cudaGetLastError());
}
