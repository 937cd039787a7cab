// Chebyshev recurrence kernels for diagonal-plus-site-flip generators
//
//     H = diag(d) + sum_j G_j X_j,    X_j flips bit j of the state index,
//
// the transverse-field Ising family at any lattice dimension.  One launch
// is one polynomial order of the Chebyshev propagator exp(-i H dt)
// (reference src/cheby.jl:150-213), fused into a single pass over the
// state:
//
//   cheby_flip_first<T>:  v1 = c (H - beta) v0,            Phi = a0 v0 + a1 v1
//   cheby_flip_iter<T>:   v2 = 2c (H - beta) v1 + v0,       Phi += a_k v2
//
// with c = i s, s = -+2/Delta (forward/backward).  The caller passes
// dmb = d - beta (real), the per-bit flip coefficients G (real, length L,
// any time-dependent control amplitude already folded in), the scalar s
// (first) or 2s (iter), and the Chebyshev coefficient(s).  An optional
// complex vector w (nullptr when unused) is added to (H - beta) v before
// the scaling: the hook through which contributions computed elsewhere
// (for example flips of bits that live on another device) enter.
//
// T = double gives the complex128 reference-accuracy tier; T = float the
// complex64 tier.  State vectors are interleaved complex (float2/double2).
//
// Replaces the Pallas TPU kernels
//   quantumpropagators/ops/fused_cheby.py     cheby_step_fused
//                                             (_first_kernel, _iter_kernel)
//   quantumpropagators/ops/fused_cheby_dd.py  cheby_step_fused_dd
//                                             (_first_component_kernel,
//                                              _iter_component_kernel,
//                                              _tail_component_kernel)
// The TPU split the flips three ways (lane bits as a 128x128 MXU matmul,
// row bits as sublane rolls, top bits in XLA) and emulated f64 with
// hi/lo f32 planes; on Hopper every flip is an index XOR and f64 is
// native, so both tiers are one template.
//
// Bound: memory.  Per element and order the iteration must read v1, v0,
// Phi and dmb and write v2 and Phi: 5.5 vectors, 88 bytes for double and
// 44 for float.  cheby_flip_first is one thread per element reading every
// neighbour v1[i ^ 2^j] from global memory.
//
// The iteration is two passes, because no single sweep over the state
// keeps every flip partner in cache: partners of bit j lie 2^j elements
// apart, and a sweep that streams ~100 bytes per element through the 50 MB
// L2 has lost the partners of bits above ~18, so each such bit re-reads
// v1 from device memory.  On an H100 a one-thread-per-element order at
// 2^24 stays flat while bits 0-17 are read and then rises ~0.1 ms per bit
// in double (PERF.md §6); a block of 2^T elements can hold the
// partners of at most T bits, whatever its shape.
//
//   cheby_flip_high<T>: w_hi = sum_{j >= L-h} G_j v1[i ^ 2^j] (+ w).  A
//     block holds a strided cube: one run of 2^line_bits contiguous
//     elements (256 bytes) for each of the 2^h values of the top h bits,
//     staged in shared memory with cp.async, so every top-bit partner is
//     read from there.  One streaming pass: read v1 (and w), write w_hi.
//   cheby_flip_iter<T>: the order over bits j < L-h, with w_hi as its w.
//     A block owns a contiguous tile of 2^tile_bits elements of v1 (16
//     KB), staged in shared memory with cp.async; flips of bits below
//     tile_bits read the tile, bits tile_bits .. L-h-1 read whole partner
//     tiles from global memory (L2), kLoadBatch loads in flight at once.
//     For L <= tile_bits the tile is the whole vector.
//
// The caller picks h, tile_bits and line_bits from L and the type
// (ops/cheby_flip.py:flip_split); h = 0 skips the high pass.  At L = 24
// the passes move 32 + 104 bytes per element (double) instead of the ~184
// of a sweep that re-reads v1 for its top bits.  Tiles of 16 KB beat 32
// and 64 KB: more blocks stay resident to hide the middle bits' L2
// latency.  Arithmetic is plain FMAs, 5-20x below the bytes' time.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxBits = 30;
constexpr int kThreads = 256;

template <typename T>
struct Complex;
template <>
struct Complex<float> {
  using type = float2;
};
template <>
struct Complex<double> {
  using type = double2;
};

// (H - beta) v at index i, plus w[i] when w is given.  sG holds G in
// shared memory.
template <typename T, typename V>
__device__ __forceinline__ V shifted_h(const V* v, const T* dmb, const T* sG,
                                       const V* w, int L, int64_t i) {
  const V x = v[i];
  const T d = dmb[i];
  T ur = d * x.x;
  T ui = d * x.y;
  for (int j = 0; j < L; ++j) {
    const V y = v[i ^ (int64_t(1) << j)];
    ur += sG[j] * y.x;
    ui += sG[j] * y.y;
  }
  if (w != nullptr) {
    const V z = w[i];
    ur += z.x;
    ui += z.y;
  }
  V u;
  u.x = ur;
  u.y = ui;
  return u;
}

template <typename T>
__global__ void cheby_flip_first(const typename Complex<T>::type* __restrict__ v0,
                                 typename Complex<T>::type* __restrict__ v1,
                                 typename Complex<T>::type* __restrict__ phi,
                                 const T* __restrict__ dmb,
                                 const T* __restrict__ G,
                                 const typename Complex<T>::type* __restrict__ w,
                                 int L, int64_t n, T s, T a0, T a1) {
  using V = typename Complex<T>::type;
  __shared__ T sG[kMaxBits];
  if (int(threadIdx.x) < L) sG[threadIdx.x] = G[threadIdx.x];
  __syncthreads();
  const int64_t stride = int64_t(blockDim.x) * gridDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const V u = shifted_h<T, V>(v0, dmb, sG, w, L, i);
    V r;  // i s u
    r.x = -s * u.y;
    r.y = s * u.x;
    v1[i] = r;
    const V x = v0[i];
    V p;
    p.x = a0 * x.x + a1 * r.x;
    p.y = a0 * x.y + a1 * r.y;
    phi[i] = p;
  }
}

// 16-byte and 8-byte asynchronous copies from global to shared memory
// (sm_80+), completed by cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename V>
__device__ __forceinline__ void cp_async_elem(V* dst, const V* src) {
  if constexpr (sizeof(V) == 16) {
    cp_async16(dst, src);
  } else {
    cp_async8(dst, src);
  }
}

// Block sizes and the number of global flip loads issued together.
constexpr int kIterThreads = 512;
constexpr int kHighThreads = 256;
constexpr int kLoadBatch = 4;
constexpr int kMaxSmem = 227 * 1024;  // shared memory a block may use

// One order over the flips of bits j < bits (bits = L - h):
//   v2 = v0 + i s2 (dmb v1 + sum_{j < bits} G_j v1[i ^ 2^j] + w),
//   Phi += ak v2.
// The block's tile of 2^tile_bits elements of v1 sits in shared memory.
// v0 and v2 may be the same buffer (v2 overwrites v0 in place): each
// thread reads v0[i] before it writes v2[i], and no thread reads another
// element of either.
template <typename T>
__global__ void __launch_bounds__(kIterThreads)
    cheby_flip_iter(const typename Complex<T>::type* v0,
                    typename Complex<T>::type* v2,
                    const typename Complex<T>::type* __restrict__ v1,
                    typename Complex<T>::type* __restrict__ phi,
                    const T* __restrict__ dmb, const T* __restrict__ G,
                    const typename Complex<T>::type* __restrict__ w,
                    int tile_bits, int bits, T s2, T ak) {
  using V = typename Complex<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  V* tile = reinterpret_cast<V*>(smem);
  __shared__ T sG[kMaxBits];
  const int tn = 1 << tile_bits;
  const int64_t base = int64_t(blockIdx.x) << tile_bits;
  {
    // 16-byte copies; a complex64 v1 at an odd element offset is only
    // 8-byte aligned and is staged one element at a time
    const V* src = v1 + base;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const char* bytes = reinterpret_cast<const char*>(src);
      const int chunks = tn * int(sizeof(V)) / 16;
      for (int c = threadIdx.x; c < chunks; c += blockDim.x)
        cp_async16(smem + 16 * c, bytes + 16 * c);
    } else {
      for (int k = threadIdx.x; k < tn; k += blockDim.x)
        cp_async_elem(tile + k, src + k);
    }
  }
  if (int(threadIdx.x) < bits) sG[threadIdx.x] = G[threadIdx.x];
  cp_async_wait_all();
  __syncthreads();
  const int lo = bits < tile_bits ? bits : tile_bits;
  for (int k = threadIdx.x; k < tn; k += blockDim.x) {
    const int64_t i = base + k;
    // streaming operands first, so their loads are in flight during the
    // flip sum
    const T d = dmb[i];
    const V x0 = v0[i];
    V p = phi[i];
    V z;
    z.x = 0;
    z.y = 0;
    if (w != nullptr) z = w[i];
    const V x = tile[k];
    T ur = d * x.x;
    T ui = d * x.y;
#pragma unroll 4
    for (int j = 0; j < lo; ++j) {
      const V y = tile[k ^ (1 << j)];
      ur += sG[j] * y.x;
      ui += sG[j] * y.y;
    }
    // bits above the tile: partners in other tiles, read from global
    // memory (L2) kLoadBatch at a time, all loads of a batch in flight
    // before the first is used
    for (int j0 = lo; j0 < bits; j0 += kLoadBatch) {
      V y[kLoadBatch];
#pragma unroll
      for (int c = 0; c < kLoadBatch; ++c)
        if (j0 + c < bits) y[c] = v1[i ^ (int64_t(1) << (j0 + c))];
#pragma unroll
      for (int c = 0; c < kLoadBatch; ++c)
        if (j0 + c < bits) {
          ur += sG[j0 + c] * y[c].x;
          ui += sG[j0 + c] * y[c].y;
        }
    }
    ur += z.x;
    ui += z.y;
    V r;  // 2c (H - beta) v1 + v0
    r.x = x0.x - s2 * ui;
    r.y = x0.y + s2 * ur;
    v2[i] = r;
    p.x += ak * r.x;
    p.y += ak * r.y;
    phi[i] = p;
  }
}

// out = sum_{r < h} G[L-h+r] v1[i ^ 2^(L-h+r)] (+ w).  Block b holds the
// cube of the 2^line_bits elements (b << line_bits) .. + 2^line_bits - 1
// of the low L-h bits, for each of the 2^h values of the top h bits:
// cube element q is global index ((q >> line_bits) << (L-h)) | (b <<
// line_bits) | (q & (2^line_bits - 1)).
template <typename T>
__global__ void __launch_bounds__(kHighThreads)
    cheby_flip_high(const typename Complex<T>::type* __restrict__ v1,
                    const T* __restrict__ G,
                    const typename Complex<T>::type* __restrict__ w,
                    typename Complex<T>::type* __restrict__ out, int L, int h,
                    int line_bits) {
  using V = typename Complex<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  V* cube = reinterpret_cast<V*>(smem);
  __shared__ T sG[kMaxBits];
  const int m = L - h;
  const int cn = 1 << (line_bits + h);
  const int line_mask = (1 << line_bits) - 1;
  const int64_t mid = int64_t(blockIdx.x) << line_bits;
  for (int q = threadIdx.x; q < cn; q += blockDim.x) {
    const int64_t i = (int64_t(q >> line_bits) << m) | mid | (q & line_mask);
    cp_async_elem(cube + q, v1 + i);
  }
  if (int(threadIdx.x) < h) sG[threadIdx.x] = G[m + threadIdx.x];
  cp_async_wait_all();
  __syncthreads();
  for (int q = threadIdx.x; q < cn; q += blockDim.x) {
    const int64_t i = (int64_t(q >> line_bits) << m) | mid | (q & line_mask);
    T ur = 0;
    T ui = 0;
    for (int r = 0; r < h; ++r) {
      const V y = cube[q ^ (1 << (line_bits + r))];
      ur += sG[r] * y.x;
      ui += sG[r] * y.y;
    }
    if (w != nullptr) {
      const V z = w[i];
      ur += z.x;
      ui += z.y;
    }
    V u;
    u.x = ur;
    u.y = ui;
    out[i] = u;
  }
}

int grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return int(blocks < (int64_t(1) << 30) ? blocks : (int64_t(1) << 30));
}

// Allows `kernel` more dynamic shared memory than the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int launch_first(const void* v0, void* v1, void* phi, const void* dmb,
                 const void* G, const void* w, int L, int64_t n, T s, T a0,
                 T a1, void* stream) {
  using V = typename Complex<T>::type;
  if (L < 1 || L > kMaxBits || n != (int64_t(1) << L))
    return int(cudaErrorInvalidValue);
  cheby_flip_first<T><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const V*)v0, (V*)v1, (V*)phi, (const T*)dmb, (const T*)G,
      (const V*)w, L, n, s, a0, a1);
  return int(cudaGetLastError());
}

template <typename T>
int launch_iter(const void* v0, void* v2, const void* v1, void* phi,
                const void* dmb, const void* G, const void* w, int L,
                int64_t n, int tile_bits, int bits, T s2, T ak,
                void* stream) {
  using V = typename Complex<T>::type;
  if (L < 1 || L > kMaxBits || n != (int64_t(1) << L) || bits < 0 ||
      bits > L || tile_bits < 0 || tile_bits > L)
    return int(cudaErrorInvalidValue);
  const int64_t bytes = (int64_t(1) << tile_bits) * int64_t(sizeof(V));
  if (bytes < 16 || bytes > kMaxSmem) return int(cudaErrorInvalidValue);
  const cudaError_t rc = allow_smem(cheby_flip_iter<T>, int(bytes));
  if (rc != cudaSuccess) return int(rc);
  cheby_flip_iter<T><<<int(n >> tile_bits), kIterThreads, int(bytes),
                       (cudaStream_t)stream>>>(
      (const V*)v0, (V*)v2, (const V*)v1, (V*)phi, (const T*)dmb,
      (const T*)G, (const V*)w, tile_bits, bits, s2, ak);
  return int(cudaGetLastError());
}

template <typename T>
int launch_high(const void* v1, const void* G, const void* w, void* out,
                int L, int64_t n, int h, int line_bits, void* stream) {
  using V = typename Complex<T>::type;
  if (L < 1 || L > kMaxBits || n != (int64_t(1) << L) || h < 1 ||
      line_bits < 0 || line_bits + h > L)
    return int(cudaErrorInvalidValue);
  const int64_t bytes = (int64_t(1) << (line_bits + h)) * int64_t(sizeof(V));
  if (bytes > kMaxSmem) return int(cudaErrorInvalidValue);
  const cudaError_t rc = allow_smem(cheby_flip_high<T>, int(bytes));
  if (rc != cudaSuccess) return int(rc);
  cheby_flip_high<T><<<int(n >> (line_bits + h)), kHighThreads, int(bytes),
                       (cudaStream_t)stream>>>(
      (const V*)v1, (const T*)G, (const V*)w, (V*)out, L, h, line_bits);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  Each returns cudaGetLastError() after
// the launch (0 on success).
extern "C" {

int cheby_flip_first_f32(const void* v0, void* v1, void* phi, const void* dmb,
                         const void* G, const void* w, int L, int64_t n,
                         float s, float a0, float a1, void* stream) {
  return launch_first<float>(v0, v1, phi, dmb, G, w, L, n, s, a0, a1, stream);
}

int cheby_flip_first_f64(const void* v0, void* v1, void* phi, const void* dmb,
                         const void* G, const void* w, int L, int64_t n,
                         double s, double a0, double a1, void* stream) {
  return launch_first<double>(v0, v1, phi, dmb, G, w, L, n, s, a0, a1,
                              stream);
}

int cheby_flip_iter_f32(const void* v0, void* v2, const void* v1, void* phi,
                        const void* dmb, const void* G, const void* w, int L,
                        int64_t n, int tile_bits, int bits, float s2,
                        float ak, void* stream) {
  return launch_iter<float>(v0, v2, v1, phi, dmb, G, w, L, n, tile_bits,
                            bits, s2, ak, stream);
}

int cheby_flip_iter_f64(const void* v0, void* v2, const void* v1, void* phi,
                        const void* dmb, const void* G, const void* w, int L,
                        int64_t n, int tile_bits, int bits, double s2,
                        double ak, void* stream) {
  return launch_iter<double>(v0, v2, v1, phi, dmb, G, w, L, n, tile_bits,
                             bits, s2, ak, stream);
}

int cheby_flip_high_f32(const void* v1, const void* G, const void* w,
                        void* out, int L, int64_t n, int h, int line_bits,
                        void* stream) {
  return launch_high<float>(v1, G, w, out, L, n, h, line_bits, stream);
}

int cheby_flip_high_f64(const void* v1, const void* G, const void* w,
                        void* out, int L, int64_t n, int h, int line_bits,
                        void* stream) {
  return launch_high<double>(v1, G, w, out, L, n, h, line_bits, stream);
}

}  // extern "C"
