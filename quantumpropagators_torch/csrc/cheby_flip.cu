// Chebyshev recurrence kernels for diagonal-plus-site-flip generators
//
//     H = diag(d) + sum_j G_j X_j,    X_j flips bit j of the state index,
//
// the transverse-field Ising family at any lattice dimension.  The setup
// and each polynomial order of the Chebyshev propagator exp(-i H dt)
// (reference src/cheby.jl:150-213) are one or two passes over the state:
//
//   setup:      v1 = c (H - beta) v0,            Phi = a0 v0 + a1 v1
//   iteration:  v2 = 2c (H - beta) v1 + v0,       Phi += a_k v2
//
// with c = i s, s = -+2/Delta (forward/backward).  The caller passes
// dmb = d - beta (real), the per-bit flip coefficients G (real, length L,
// any time-dependent control amplitude already folded in), the scalar s
// (setup) or 2s (iteration), and the Chebyshev coefficient(s).  An optional
// complex vector w (nullptr when unused) is added to (H - beta) v before
// the scaling: the hook through which contributions computed elsewhere
// enter.  Flips of bits that live outside the state (a sharded state's
// slot bits) enter the high pass as partner rows, each weighted by its
// own entry of G after the L local bits.
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
// 44 for float; the setup reads v0 and dmb and writes v1 and Phi: 3.5
// vectors, 56 and 28 bytes.  The high pass with P partner rows reads x
// and the partners and writes w_hi: 32 + 16 P bytes in double, 16 + 8 P
// in float (at h = 0 x is not read).
//
// Both are two passes, because no single sweep over the state keeps every
// flip partner in cache: partners of bit j lie 2^j elements apart, and a
// sweep that streams ~100 bytes per element through the 50 MB L2 has lost
// the partners of bits above ~18, so each such bit re-reads the state
// from device memory.  On an H100 a one-thread-per-element order at 2^24
// stays flat while bits 0-17 are read and then rises ~0.1 ms per bit in
// double (PERF.md §6); a block of 2^T elements can hold the partners of at
// most T bits, whatever its shape.  Below, x is the vector whose flips
// are summed: v1 in the iteration, v0 in the setup.
//
//   cheby_flip_high<T>: w_hi = sum_{j >= L-h} G_j x[i ^ 2^j]
//     + sum_{r < P} G_{L+r} p_r[i] (+ w).  A block holds a strided cube:
//     one run of 2^line_bits contiguous elements (256 bytes) for each of
//     the 2^h values of the top h bits, staged in shared memory with
//     cp.async, so every top-bit partner is read from there.  The P <=
//     kMaxPartners partner rows p_r are flips of bits held outside x (a
//     sharded state's slot bits: another row of the slot stack, or rows
//     received from another rank); they are read at the output's own
//     index.  One streaming pass: read x (and the partners, and w), write
//     w_hi.  With h = 0 nothing is staged: the pass is the partners'
//     weighted sum (plus w).  Two kernels share the helpers: without
//     partners (the unsharded path) cheby_flip_high<T> takes no partner
//     table; cheby_flip_high_partners<T> takes up to kMaxPartners = 30
//     row pointers by value (240 bytes, one per slot bit of any mesh) and
//     reads them from its parameters in a run-time loop over batches of
//     kPartnerBatch loads.  Its cube holds at least 2^10 elements, four a
//     thread, whatever h (ops/cheby_flip.py:_line_bits).
//   cheby_flip_tiled<T, First>: the order (First = false) or the setup
//     (First = true) over bits j < L-h, with w_hi as its w.  A block owns
//     a contiguous tile of 2^tile_bits elements of x (16 KB), staged in
//     shared memory with cp.async; flips of bits below tile_bits read the
//     tile, bits tile_bits .. L-h-1 read whole partner tiles from global
//     memory (L2), a batch of loads in flight at once.  For L <= tile_bits
//     the tile is the whole vector.  The setup takes v0[i] from its own
//     tile and has no v0 or Phi stream to read; its tile is 2^11 elements
//     (32 KB in double), the iteration's 16 KB.  Its Phi weights are
//     kernel arguments, or (Loaded = true, a third template argument) read
//     from the device: a replayed graph's coefficients that are data.
//
// The caller picks h, tile_bits and line_bits from L and the type
// (ops/cheby_flip.py:flip_split); h = 0 skips the high pass.  At L = 24
// the passes move 32 + 104 bytes per element for an order and 32 + 72 for
// the setup (double) instead of the ~184 / ~152 of a sweep that re-reads
// the state for its top bits.  For the iteration, tiles of 16 KB beat 32
// and 64 KB: more blocks stay resident to hide the middle bits' L2
// latency.  Arithmetic is plain FMAs, 5-20x below the bytes' time.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxBits = 30;

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

// Block sizes and the number of global flip loads in flight together:
// the setup, with fewer streams of its own to hide their latency, loads
// all of its L2 partners (7 at L = 24) in one batch.
constexpr int kTiledThreads = 512;
constexpr int kHighThreads = 256;
constexpr int kLoadBatch = 4;
constexpr int kFirstLoadBatch = 8;
constexpr int kMaxSmem = 227 * 1024;  // shared memory a block may use
// partner rows of one high pass: one per slot bit of any mesh, loaded a
// batch at a time
constexpr int kMaxPartners = kMaxBits;
constexpr int kPartnerBatch = 4;

// One pass over the flips of bits j < bits (bits = L - h) of x:
//   u = dmb x + sum_{j < bits} G_j x[i ^ 2^j] + w, then
//   the iteration (First = false, x = v1):  out = v0 + i s u,  Phi += a out;
//   the setup     (First = true,  x = v0):  out = i s u,  Phi = a0 x + a out.
// a and a0 are the scalars given, or with Loaded the values at a_ptr and
// a0_ptr: coefficients that are data on the device (a replayed graph then
// takes new coefficients).  Loaded is its own instantiation, so that the
// scalars' instantiation keeps its registers.
// The block's tile of 2^tile_bits elements of x sits in shared memory.
// In the iteration v0 and out may be the same buffer (out overwrites v0 in
// place): each thread reads v0[i] before it writes out[i], and no thread
// reads another element of either.  The setup reads neither v0 (nullptr)
// nor Phi: x[i] comes from the tile, and Phi is only written.
template <typename T, bool First, bool Loaded>
__global__ void __launch_bounds__(kTiledThreads)
    cheby_flip_tiled(const typename Complex<T>::type* v0,
                     typename Complex<T>::type* out,
                     const typename Complex<T>::type* __restrict__ x,
                     typename Complex<T>::type* __restrict__ phi,
                     const T* __restrict__ dmb, const T* __restrict__ G,
                     const typename Complex<T>::type* __restrict__ w,
                     int tile_bits, int bits, T s, T a, T a0,
                     const T* __restrict__ a_ptr,
                     const T* __restrict__ a0_ptr) {
  using V = typename Complex<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (Loaded) {
    a = __ldg(a_ptr);
    if constexpr (First) a0 = __ldg(a0_ptr);
  }
  V* tile = reinterpret_cast<V*>(smem);
  __shared__ T sG[kMaxBits];
  const int tn = 1 << tile_bits;
  const int64_t base = int64_t(blockIdx.x) << tile_bits;
  {
    // 16-byte copies; a complex64 x at an odd element offset is only
    // 8-byte aligned and is staged one element at a time
    const V* src = x + base;
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
    V x0, p;
    if constexpr (!First) {
      x0 = v0[i];
      p = phi[i];
    }
    V z;
    z.x = 0;
    z.y = 0;
    if (w != nullptr) z = w[i];
    const V xi = tile[k];
    T ur = d * xi.x;
    T ui = d * xi.y;
#pragma unroll 4
    for (int j = 0; j < lo; ++j) {
      const V y = tile[k ^ (1 << j)];
      ur += sG[j] * y.x;
      ui += sG[j] * y.y;
    }
    // bits above the tile: partners in other tiles, read from global
    // memory (L2) a batch at a time, all loads of a batch in flight
    // before the first is used
    constexpr int batch = First ? kFirstLoadBatch : kLoadBatch;
    for (int j0 = lo; j0 < bits; j0 += batch) {
      V y[batch];
#pragma unroll
      for (int c = 0; c < batch; ++c)
        if (j0 + c < bits) y[c] = x[i ^ (int64_t(1) << (j0 + c))];
#pragma unroll
      for (int c = 0; c < batch; ++c)
        if (j0 + c < bits) {
          ur += sG[j0 + c] * y[c].x;
          ui += sG[j0 + c] * y[c].y;
        }
    }
    ur += z.x;
    ui += z.y;
    V r;
    if constexpr (First) {  // c (H - beta) v0
      r.x = -s * ui;
      r.y = s * ur;
      p.x = a0 * xi.x + a * r.x;
      p.y = a0 * xi.y + a * r.y;
    } else {  // 2c (H - beta) v1 + v0
      r.x = x0.x - s * ui;
      r.y = x0.y + s * ur;
      p.x += a * r.x;
      p.y += a * r.y;
    }
    out[i] = r;
    phi[i] = p;
  }
}

// The device pointers of one slot launch's partner rows, passed by value:
// one per slot bit of any mesh the kernels can address.
template <typename V>
struct Partners {
  const V* row[kMaxPartners];
};

// out = sum_{r < h} G[L-h+r] x[i ^ 2^(L-h+r)]
//       + sum_{r < P} G[L+r] partners.row[r][i] (+ w),
// summed in that order: the top bits from the lowest up, then the
// partners in list order, then w (the plain version's order).  Block b
// holds the cube of the 2^line_bits elements (b << line_bits) .. +
// 2^line_bits - 1 of the low L-h bits, for each of the 2^h values of the
// top h bits: cube element q is global index ((q >> line_bits) << (L-h))
// | (b << line_bits) | (q & (2^line_bits - 1)).  The coefficients are
// read from the device vector G (L + P entries), so a captured launch
// reads the values G holds at each replay.  Two kernels: without partners
// (cheby_flip_high, the unsharded path, h >= 1) and with them
// (cheby_flip_high_partners, h >= 0), sharing the helpers below.

// Global index of cube element q.
__device__ __forceinline__ int64_t cube_index(int q, int m, int line_bits,
                                              int64_t mid) {
  return (int64_t(q >> line_bits) << m) | mid | (q & ((1 << line_bits) - 1));
}

// Stages the block's cube of x (cn elements) and the top bits' weights.
template <typename T, typename V>
__device__ __forceinline__ void stage_cube(V* cube, T* sG, const V* x,
                                           const T* G, int m, int h, int cn,
                                           int line_bits, int64_t mid) {
  for (int q = threadIdx.x; q < cn; q += blockDim.x)
    cp_async_elem(cube + q, x + cube_index(q, m, line_bits, mid));
  if (int(threadIdx.x) < h) sG[threadIdx.x] = G[m + threadIdx.x];
}

// ur + i ui += the top h bits' flips of cube element q, lowest bit first.
template <typename T, typename V>
__device__ __forceinline__ void add_top_bits(const V* cube, const T* sG,
                                             int q, int h, int line_bits,
                                             T& ur, T& ui) {
  for (int r = 0; r < h; ++r) {
    const V y = cube[q ^ (1 << (line_bits + r))];
    ur += sG[r] * y.x;
    ui += sG[r] * y.y;
  }
}

// out[i] = ur + i ui (+ w[i]).
template <typename T, typename V>
__device__ __forceinline__ void store_high(V* out, const V* w, int64_t i,
                                           T ur, T ui) {
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

// The high pass without partners: the top h >= 1 bits (+ w).
template <typename T>
__global__ void __launch_bounds__(kHighThreads)
    cheby_flip_high(const typename Complex<T>::type* __restrict__ x,
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
  const int64_t mid = int64_t(blockIdx.x) << line_bits;
  stage_cube(cube, sG, x, G, m, h, cn, line_bits, mid);
  cp_async_wait_all();
  __syncthreads();
  for (int q = threadIdx.x; q < cn; q += blockDim.x) {
    T ur = 0;
    T ui = 0;
    add_top_bits(cube, sG, q, h, line_bits, ur, ui);
    store_high(out, w, cube_index(q, m, line_bits, mid), ur, ui);
  }
}

// The high pass with 1 <= n_partners <= kMaxPartners partner rows, read
// at the output's own index (2^line_bits consecutive elements a line,
// coalesced) from the parameter table at compile-time offsets, a batch
// of kPartnerBatch loads in flight before the first is added.  With
// h = 0 nothing is staged: the partners' weighted sum (+ w).
template <typename T>
__global__ void __launch_bounds__(kHighThreads)
    cheby_flip_high_partners(const typename Complex<T>::type* __restrict__ x,
                             const T* __restrict__ G,
                             const typename Complex<T>::type* __restrict__ w,
                             Partners<typename Complex<T>::type> partners,
                             int n_partners,
                             typename Complex<T>::type* __restrict__ out,
                             int L, int h, int line_bits) {
  using V = typename Complex<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  V* cube = reinterpret_cast<V*>(smem);
  __shared__ T sG[kMaxBits];
  __shared__ T sP[kMaxPartners];
  const int m = L - h;
  const int cn = 1 << (line_bits + h);
  const int64_t mid = int64_t(blockIdx.x) << line_bits;
  if (h > 0) stage_cube(cube, sG, x, G, m, h, cn, line_bits, mid);
  if (int(threadIdx.x) < n_partners) sP[threadIdx.x] = G[L + threadIdx.x];
  cp_async_wait_all();
  __syncthreads();
  for (int q = threadIdx.x; q < cn; q += blockDim.x) {
    const int64_t i = cube_index(q, m, line_bits, mid);
    T ur = 0;
    T ui = 0;
    add_top_bits(cube, sG, q, h, line_bits, ur, ui);
    // a run-time loop over batches: unrolled over the whole table, the
    // compiler issued every predicated load first (98-123 registers)
#pragma unroll 1
    for (int r0 = 0; r0 < n_partners; r0 += kPartnerBatch) {
      V y[kPartnerBatch];
#pragma unroll
      for (int c = 0; c < kPartnerBatch; ++c)
        if (r0 + c < n_partners) y[c] = partners.row[r0 + c][i];
#pragma unroll
      for (int c = 0; c < kPartnerBatch; ++c)
        if (r0 + c < n_partners) {
          ur += sP[r0 + c] * y[c].x;
          ui += sP[r0 + c] * y[c].y;
        }
    }
    store_high(out, w, i, ur, ui);
  }
}

// Allows `kernel` more dynamic shared memory than the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, bool First, bool Loaded>
int launch_tiled_as(const void* v0, void* out, const void* x, void* phi,
                 const void* dmb, const void* G, const void* w, int L,
                 int64_t n, int tile_bits, int bits, T s, T a, T a0,
                 const void* a_ptr, const void* a0_ptr, void* stream) {
  using V = typename Complex<T>::type;
  if (L < 1 || L > kMaxBits || n != (int64_t(1) << L) || bits < 0 ||
      bits > L || tile_bits < 0 || tile_bits > L)
    return int(cudaErrorInvalidValue);
  const int64_t bytes = (int64_t(1) << tile_bits) * int64_t(sizeof(V));
  if (bytes < 16 || bytes > kMaxSmem) return int(cudaErrorInvalidValue);
  const cudaError_t rc =
      allow_smem(cheby_flip_tiled<T, First, Loaded>, int(bytes));
  if (rc != cudaSuccess) return int(rc);
  cheby_flip_tiled<T, First, Loaded><<<int(n >> tile_bits), kTiledThreads,
                                       int(bytes), (cudaStream_t)stream>>>(
      (const V*)v0, (V*)out, (const V*)x, (V*)phi, (const T*)dmb,
      (const T*)G, (const V*)w, tile_bits, bits, s, a, a0, (const T*)a_ptr,
      (const T*)a0_ptr);
  return int(cudaGetLastError());
}

// The tiled pass with its coefficients as scalars (both pointers null) or
// read on the device (a_ptr, and for the setup a0_ptr, given).
template <typename T, bool First>
int launch_tiled(const void* v0, void* out, const void* x, void* phi,
                 const void* dmb, const void* G, const void* w, int L,
                 int64_t n, int tile_bits, int bits, T s, T a, T a0,
                 const void* a_ptr, const void* a0_ptr, void* stream) {
  if (a_ptr == nullptr) {
    if (a0_ptr != nullptr) return int(cudaErrorInvalidValue);
    return launch_tiled_as<T, First, false>(v0, out, x, phi, dmb, G, w, L, n,
                                            tile_bits, bits, s, a, a0,
                                            nullptr, nullptr, stream);
  }
  if (First && a0_ptr == nullptr) return int(cudaErrorInvalidValue);
  return launch_tiled_as<T, First, true>(v0, out, x, phi, dmb, G, w, L, n,
                                         tile_bits, bits, s, a, a0, a_ptr,
                                         a0_ptr, stream);
}

template <typename T>
int launch_high(const void* x, const void* G, const void* w,
                const void* const* partners, int n_partners, void* out,
                int L, int64_t n, int h, int line_bits, void* stream) {
  using V = typename Complex<T>::type;
  if (L < 1 || L > kMaxBits || n != (int64_t(1) << L) || h < 0 ||
      line_bits < 0 || line_bits + h > L || n_partners < 0 ||
      n_partners > kMaxPartners || (h == 0 && n_partners == 0))
    return int(cudaErrorInvalidValue);
  // h = 0 stages nothing
  const int64_t bytes =
      h ? (int64_t(1) << (line_bits + h)) * int64_t(sizeof(V)) : 0;
  if (bytes > kMaxSmem) return int(cudaErrorInvalidValue);
  const int blocks = int(n >> (line_bits + h));
  if (n_partners == 0) {
    const cudaError_t rc = allow_smem(cheby_flip_high<T>, int(bytes));
    if (rc != cudaSuccess) return int(rc);
    cheby_flip_high<T><<<blocks, kHighThreads, int(bytes),
                         (cudaStream_t)stream>>>(
        (const V*)x, (const T*)G, (const V*)w, (V*)out, L, h, line_bits);
    return int(cudaGetLastError());
  }
  Partners<V> rows{};
  for (int r = 0; r < n_partners; ++r) {
    if (partners[r] == nullptr) return int(cudaErrorInvalidValue);
    rows.row[r] = static_cast<const V*>(partners[r]);
  }
  const cudaError_t rc = allow_smem(cheby_flip_high_partners<T>, int(bytes));
  if (rc != cudaSuccess) return int(rc);
  cheby_flip_high_partners<T><<<blocks, kHighThreads, int(bytes),
                                (cudaStream_t)stream>>>(
      (const V*)x, (const T*)G, (const V*)w, rows, n_partners, (V*)out, L, h,
      line_bits);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  Each returns cudaGetLastError() after
// the launch (0 on success).
extern "C" {

// The setup's tiled pass: v1 and Phi from v0.  a0_ptr / a1_ptr (may be
// null): a0 / a1 read on the device instead.
int cheby_flip_first_f32(const void* v0, void* v1, void* phi, const void* dmb,
                         const void* G, const void* w, int L, int64_t n,
                         int tile_bits, int bits, float s, float a0, float a1,
                         const void* a0_ptr, const void* a1_ptr,
                         void* stream) {
  return launch_tiled<float, true>(nullptr, v1, v0, phi, dmb, G, w, L, n,
                                   tile_bits, bits, s, a1, a0, a1_ptr, a0_ptr,
                                   stream);
}

int cheby_flip_first_f64(const void* v0, void* v1, void* phi, const void* dmb,
                         const void* G, const void* w, int L, int64_t n,
                         int tile_bits, int bits, double s, double a0,
                         double a1, const void* a0_ptr, const void* a1_ptr,
                         void* stream) {
  return launch_tiled<double, true>(nullptr, v1, v0, phi, dmb, G, w, L, n,
                                    tile_bits, bits, s, a1, a0, a1_ptr,
                                    a0_ptr, stream);
}

// The iteration's tiled pass: v2 from v0 and v1, Phi updated.  ak_ptr (may
// be null): a_k read on the device instead.
int cheby_flip_iter_f32(const void* v0, void* v2, const void* v1, void* phi,
                        const void* dmb, const void* G, const void* w, int L,
                        int64_t n, int tile_bits, int bits, float s2,
                        float ak, const void* ak_ptr, void* stream) {
  return launch_tiled<float, false>(v0, v2, v1, phi, dmb, G, w, L, n,
                                    tile_bits, bits, s2, ak, 0.0f, ak_ptr,
                                    nullptr, stream);
}

int cheby_flip_iter_f64(const void* v0, void* v2, const void* v1, void* phi,
                        const void* dmb, const void* G, const void* w, int L,
                        int64_t n, int tile_bits, int bits, double s2,
                        double ak, const void* ak_ptr, void* stream) {
  return launch_tiled<double, false>(v0, v2, v1, phi, dmb, G, w, L, n,
                                     tile_bits, bits, s2, ak, 0.0, ak_ptr,
                                     nullptr, stream);
}

// The high pass of either: w_hi from x (v1 or v0) and the n_partners
// device pointers of the host array partners (nullptr when n_partners is
// 0: the kernel without a partner table).
int cheby_flip_high_f32(const void* x, const void* G, const void* w,
                        const void* const* partners, int n_partners,
                        void* out, int L, int64_t n, int h, int line_bits,
                        void* stream) {
  return launch_high<float>(x, G, w, partners, n_partners, out, L, n, h,
                            line_bits, stream);
}

int cheby_flip_high_f64(const void* x, const void* G, const void* w,
                        const void* const* partners, int n_partners,
                        void* out, int L, int64_t n, int h, int line_bits,
                        void* stream) {
  return launch_high<double>(x, G, w, partners, n_partners, out, L, n, h,
                             line_bits, stream);
}

}  // extern "C"
