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
// Bound: memory.  Per element and order the iteration reads v1, v0, Phi
// and dmb and writes v2 and Phi: 5.5 vectors, 88 bytes for double and 44
// for float.  The L neighbour reads v1[i ^ 2^j] hit L1/L2 for the low
// bits (the partner lies in the same or a nearby line); bits whose
// partner lies further away than the cache holds cost a further read of
// v1 from device memory each.  This first version is one thread per
// element reading every neighbour from global memory.  Serving bits 0-4
// by warp shuffles and the middle bits from shared memory, so that only
// the top bits leave the SM, is work for later.

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

// v0 and v2 may be the same buffer (v2 overwrites v0 in place): each
// thread reads v0[i] before it writes v2[i], and no thread reads another
// element of either.
template <typename T>
__global__ void cheby_flip_iter(const typename Complex<T>::type* v0,
                                typename Complex<T>::type* v2,
                                const typename Complex<T>::type* __restrict__ v1,
                                typename Complex<T>::type* __restrict__ phi,
                                const T* __restrict__ dmb,
                                const T* __restrict__ G,
                                const typename Complex<T>::type* __restrict__ w,
                                int L, int64_t n, T s2, T ak) {
  using V = typename Complex<T>::type;
  __shared__ T sG[kMaxBits];
  if (int(threadIdx.x) < L) sG[threadIdx.x] = G[threadIdx.x];
  __syncthreads();
  const int64_t stride = int64_t(blockDim.x) * gridDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const V u = shifted_h<T, V>(v1, dmb, sG, w, L, i);
    const V x0 = v0[i];
    V r;  // 2c (H - beta) v1 + v0
    r.x = x0.x - s2 * u.y;
    r.y = x0.y + s2 * u.x;
    v2[i] = r;
    V p = phi[i];
    p.x += ak * r.x;
    p.y += ak * r.y;
    phi[i] = p;
  }
}

int grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return int(blocks < (int64_t(1) << 30) ? blocks : (int64_t(1) << 30));
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
                int64_t n, T s2, T ak, void* stream) {
  using V = typename Complex<T>::type;
  if (L < 1 || L > kMaxBits || n != (int64_t(1) << L))
    return int(cudaErrorInvalidValue);
  cheby_flip_iter<T><<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const V*)v0, (V*)v2, (const V*)v1, (V*)phi, (const T*)dmb,
      (const T*)G, (const V*)w, L, n, s2, ak);
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
                        int64_t n, float s2, float ak, void* stream) {
  return launch_iter<float>(v0, v2, v1, phi, dmb, G, w, L, n, s2, ak, stream);
}

int cheby_flip_iter_f64(const void* v0, void* v2, const void* v1, void* phi,
                        const void* dmb, const void* G, const void* w, int L,
                        int64_t n, double s2, double ak, void* stream) {
  return launch_iter<double>(v0, v2, v1, phi, dmb, G, w, L, n, s2, ak,
                             stream);
}

}  // extern "C"
