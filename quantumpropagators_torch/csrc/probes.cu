// Measurement kernels: the H100 counterparts of the TPU probes under
// docs/profiling/.  Each computes, as a function of the flat element index
// of its planes (lane bits 0-6, row bits from 7 in the TPU's (rows, 128)
// layout), what one Pallas probe body computes; none of them is on a
// propagation path.  ops/probes.py wraps each and holds its plain PyTorch
// version beside it.
//
//   probe_stream<Op>        streaming element-wise bodies over up to 16 f32
//                           planes, each read at its own tile (self, (t+d)
//                           mod T, or t^d): copy, scaled copy, add, n-input
//                           sums, triad x + y*z, the 16-to-2 scatter body
//                           with its FMA chain, a = a*mul + b chains.
//     replaces docs/profiling/scratch_roofline.py:19 (mk), :59's stream
//     companions, scratch_r3_roofline.py:20, scratch_r3_probe2.py:50,
//     scratch_r3_probe3.py:44, probe_scatter_r4.py:113 (build, kernel).
//     Bound: bytes.  One block a chunk of 256 float4s (no stride loop),
//     one float4 of each input a thread, in registers sized to the body's
//     plane count; map kinds are compile-time, so all-self bodies are a
//     straight 16-byte stream.  tools/stream_variants.py times the
//     alternatives.
//   probe_stream_pipelined  the same 16-plane sum through a two-stage
//                           cp.async ring in shared memory (persistent
//                           blocks, wait_group completion).
//     replaces probe_scatter_r4.py:225 (build_manual).  Bound: bytes.
//   probe_flipsum<V>        x[i] + sum_{lo <= j < hi} x[i ^ 2^j] as
//                           (a) gather from global memory through L1/L2,
//                           (b) a shared-memory tile, (c) __shfl_xor_sync
//                           for bits 0-4 and the tile above, (d) bits 0-6
//                           as a 0/1 (128, 128) product on the tensor cores
//                           (two TF32 passes, the plane split hi + lo) and
//                           the tile above.
//     replaces scratch_flips.py:20, and the roll / grouped-roll flip sums of
//     scratch_roofline.py:19, scratch_r3_roofline.py:20 and
//     scratch_r3_probe2.py:50.  Bound: bytes (one read, one write).  (b)
//     and (d) load their tiles by TMA bulk copies: (b) one block a tile, a
//     float4 of outputs a thread, its in-tile partners one LDS.128 each;
//     (d) the TF32 tile product's pipeline (persistent blocks, a ring of
//     stages) with B = A01.
//   probe_tile_mma          an (R, 128) plane times a (128, 128) matrix:
//                           TF32 and 3xTF32 (lo*Mhi + hi*Mlo + hi*Mhi, the
//                           operands split in registers and in shared
//                           memory) by wgmma m64n128k8 (A from registers,
//                           B from shared memory); FP64 by mma.sync
//                           m16n8k16.
//     replaces scratch_roofline.py:59, scratch_flips.py:132 and
//     scratch_r3_probe4.py:50.  Bound: bytes at the timed sizes ((2^19,
//     128) f32, (2^18, 128) f64: 0.1603 ms at 3.35 TB/s), the FP64
//     operations (0.128 ms at 67 TFLOP/s) and 3xTF32's three TF32 passes
//     (0.104 ms at 495 TFLOP/s) close behind.  So each kernel holds M (for
//     3xTF32 its hi and lo parts) in shared memory for a persistent
//     block's life, in the layout the MMA reads, and streams x through a
//     three-stage ring of TMA bulk copies that run under the MMAs and the
//     stores.
//   probe_smem              one block with `bytes` of dynamic shared memory:
//                           x is staged at the top of the allocation and
//                           written back doubled; launching proves the size.
//     replaces scratch_r3_roofline.py:108 (the VMEM scratch probe).
//   probe_flip_order<Body, Nb>  a copy of cheby_flip.cu's tiled order pass
//                           (cheby_flip_tiled<double, false>) with Body =
//                           full (the order), noflips (the order without
//                           its in-tile flip sum) or copy (the same streams
//                           summed unweighted, no arithmetic), and the
//                           partners above the tile read at i ^ 2^j (xor),
//                           at i (self) or not at all (none).
//     replaces scratch_prof_dd.py:95 and scratch_prof2.py:94.  Bound: bytes.
//   probe_fma_residual<T>   p = a*b, r = a*b - p as the library's flags
//                           compile it (inline: nvcc may evaluate a*b once;
//                           loaded: a, b and p read back through volatile
//                           loads, so a*b - p can only be contracted), and
//                           with __fmul_rn/__fsub_rn.
//     replaces scratch_r3_probe2.py:25, scratch_r3_probe3.py:26.
//   probe_extract           sigma = 64 max|x| over the block, q = (sigma +
//                           x) - sigma, r = x - q.
//     replaces scratch_r3_probe4.py:23.
//   probe_xor_permute<V>    out[i] = x[i ^ 2^bit] by __shfl_xor_sync (bit <
//                           5) or through a shared-memory tile (bit < 12).
//     replaces scratch_r3_probe4.py:70 (the grouped row roll).
//
// The TPU timed each body inside a jitted scan and took differences of
// run lengths; here each launch is timed alone with CUDA events.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxPlanes = 16;
constexpr int kThreads = 256;
constexpr int kOrderThreads = 512;
constexpr int kMaxFlipBits = 16;
constexpr int kMaxBits = 30;
constexpr int kMaxSmem = 227 * 1024;  // shared memory a block may use
constexpr int kPermTile = 4096;       // probe_xor_permute's tile (16 KB)
constexpr uint32_t kOneTf32 = 0x3f800000u;  // 1.0f, exact in TF32

// Up to 16 f32 planes and how each is read: element e of the output takes
// element e of plane k (kind 0), or the same offset in tile (t + dist) mod
// T (kind 1) or t ^ dist (kind 2), with tiles of 2^tile_bits elements.
struct Planes {
  const float* in[kMaxPlanes];
  int kind[kMaxPlanes];
  int dist[kMaxPlanes];
};

enum MapKind { kSelf = 0, kStride = 1, kXor = 2 };
enum StreamOp { kSum = 0, kTriad = 1, kChain = 2 };
enum FlipVariant { kGather = 0, kTile = 1, kShfl = 2, kMma = 3 };
enum OrderBody { kFull = 0, kCopy = 1, kNoFlips = 2 };
enum OrderNb { kNbXor = 0, kNbSelf = 1, kNbNone = 2 };

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// Blocks of `threads` for `work` items in a grid-stride loop: one item a
// thread, at most 16 blocks per SM.
int grid_for(int64_t work, int threads) {
  const int64_t want = (work + threads - 1) / threads;
  const int64_t cap = int64_t(sm_count()) * 16;
  return int(want < 1 ? 1 : (want < cap ? want : cap));
}

// Raises `kernel`'s dynamic shared memory limit to `bytes`, once: `granted`
// (a static of the launch site) keeps the largest limit set, so that a
// launch recorded into a CUDA graph after a first eager launch sets nothing.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int& granted) {
  if (bytes <= 48 * 1024 || bytes <= granted) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess) granted = bytes;
  return rc;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ---------------------------------------------------------------- stream

// Streaming loads and stores, 16 bytes each, in the default cache policy:
// with the evict-first hints (ld.global.cs / st.global.cs) the triad and
// the 16-plane sums read as fast in one process and 2-4 % slower in
// another (tools/stream_variants.py, tools/probe_ab.py).
__device__ __forceinline__ float4 ld_stream(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void st_stream(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

// Element e's float4 of plane k: with Mapped, through the plane's tile map;
// without, at e itself (every plane `self`: a straight stream).
template <bool Mapped>
__device__ __forceinline__ float4 load_plane(const Planes& p, int k,
                                             int64_t e, int tile_bits,
                                             int64_t n_tiles) {
  int64_t idx = e;
  if (Mapped && p.kind[k] != kSelf) {
    const int64_t t = e >> tile_bits;
    const int64_t t2 = p.kind[k] == kStride ? (t + p.dist[k]) % n_tiles
                                            : (t ^ int64_t(p.dist[k]));
    idx = (t2 << tile_bits) | (e & ((int64_t(1) << tile_bits) - 1));
  }
  return ld_stream(p.in[k] + idx);
}

// One output float4 of probe_stream from its inputs y[0 .. n_in):
// kSum:   s = in_0 + in_1 + ... (left to right); t = s, chain times
//         t = t*mul + s; returns t*scale, and s*0.5 in `half`.
// kTriad: in_0 + in_1*in_2.
// kChain: a = in_0, chain times a = a*mul + in_1; returns a.
template <int Op, int MaxIn>
__device__ __forceinline__ float4 stream_body(const float4 (&y)[MaxIn],
                                              int n_in, int chain, float mul,
                                              float scale, float4& half) {
  if constexpr (Op == kSum) {
    float4 s = y[0];
#pragma unroll
    for (int k = 1; k < MaxIn; ++k)
      if (k < n_in) s = add4(s, y[k]);
    float4 t = s;
    for (int c = 0; c < chain; ++c) {
      t.x = t.x * mul + s.x;
      t.y = t.y * mul + s.y;
      t.z = t.z * mul + s.z;
      t.w = t.w * mul + s.w;
    }
    half = make_float4(s.x * 0.5f, s.y * 0.5f, s.z * 0.5f, s.w * 0.5f);
    return make_float4(t.x * scale, t.y * scale, t.z * scale, t.w * scale);
  } else if constexpr (Op == kTriad) {
    return make_float4(y[0].x + y[1].x * y[2].x, y[0].y + y[1].y * y[2].y,
                       y[0].z + y[1].z * y[2].z, y[0].w + y[1].w * y[2].w);
  } else {
    float4 a = y[0];
    for (int c = 0; c < chain; ++c) {
      a.x = a.x * mul + y[1].x;
      a.y = a.y * mul + y[1].y;
      a.z = a.z * mul + y[1].z;
      a.w = a.w * mul + y[1].w;
    }
    return a;
  }
}

// Each block covers one chunk of kThreads x U float4s of every plane
// (exact cover: one chunk a block, no stride loop); thread i takes float4s
// i, i + kThreads, ... of it, so that each load instruction of a warp reads
// 512 contiguous bytes, and loads all U x MaxIn of them before it uses the
// first.  U = 1: at 2^26 elements one float4 a thread, more threads
// resident, read faster than 4 or 8 a thread, and the grid-stride loop of
// 16 blocks an SM was 2-11 % slower (tools/stream_variants.py).  MaxIn is
// the plane count of the small bodies (copy 1, add and chain 2, triad 3,
// sums of 3 or 4: 4) and 16 for the n-input sums, so that registers go to
// loads in flight and not to planes a body lacks.  Half: the second
// output s/2 exists.
template <int Op, int MaxIn, int U, bool Mapped, bool Half>
__global__ void __launch_bounds__(kThreads)
    probe_stream_kernel(const Planes p, float* __restrict__ o1,
                        float* __restrict__ o2, int n_in, int64_t n4,
                        int tile_bits, int64_t n_tiles, int chain, float mul,
                        float scale) {
  const int64_t n_chunks = (n4 + kThreads * U - 1) / (kThreads * U);
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int64_t v0 = c * (kThreads * U) + threadIdx.x;
    float4 y[U][MaxIn];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < MaxIn; ++k)
        if (k < n_in && v0 + u * kThreads < n4)
          y[u][k] = load_plane<Mapped>(p, k, (v0 + u * kThreads) << 2,
                                       tile_bits, n_tiles);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t v = v0 + u * kThreads;
      if (v < n4) {
        float4 half;
        st_stream(o1 + (v << 2),
                  stream_body<Op, MaxIn>(y[u], n_in, chain, mul, scale, half));
        if constexpr (Half) st_stream(o2 + (v << 2), half);
      }
    }
  }
}

bool planes_ok(const Planes& p, int n_in, int64_t n_tiles) {
  for (int k = 0; k < n_in; ++k) {
    if (p.in[k] == nullptr ||
        (reinterpret_cast<uintptr_t>(p.in[k]) & 15) != 0)
      return false;
    if (p.kind[k] == kStride && p.dist[k] < 0) return false;
    if (p.kind[k] == kXor && (p.dist[k] < 0 || p.dist[k] >= n_tiles ||
                              (n_tiles & (n_tiles - 1)) != 0))
      return false;  // t ^ dist must stay below the tile count
    if (p.kind[k] < kSelf || p.kind[k] > kXor) return false;
  }
  return true;
}

// ------------------------------------------------------ stream, pipelined

// Persistent blocks walk chunks c = blockIdx.x, + gridDim.x, ...; chunk c
// is elements [c*chunk, (c+1)*chunk) of every plane.  Stage c+gridDim.x's
// copies are issued before chunk c is summed; each thread sums exactly the
// float4s it copied itself.
__global__ void __launch_bounds__(kThreads)
    probe_stream_pipelined_kernel(const Planes p, float* __restrict__ out,
                                  int n_in, int64_t n_chunks, int chunk,
                                  int chain, float mul) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);
  const int per_stage = n_in * chunk;
  const int n4 = chunk >> 2;
  auto issue = [&](int64_t c, int stage) {
    float* dst = buf + stage * per_stage;
#pragma unroll
    for (int k = 0; k < kMaxPlanes; ++k)
      if (k < n_in) {
        const float* src = p.in[k] + c * chunk;
        for (int q = threadIdx.x; q < n4; q += blockDim.x)
          cp_async16(dst + k * chunk + 4 * q, src + 4 * q);
      }
  };
  int64_t c = blockIdx.x;
  if (c < n_chunks) issue(c, 0);
  cp_async_commit();
  int stage = 0;
  for (; c < n_chunks; c += gridDim.x) {
    const int64_t next = c + gridDim.x;
    if (next < n_chunks) issue(next, stage ^ 1);
    cp_async_commit();
    cp_async_wait_group<1>();  // all but the group just issued are done
    __syncthreads();
    const float* cur = buf + stage * per_stage;
    for (int q = threadIdx.x; q < n4; q += blockDim.x) {
      float4 s = reinterpret_cast<const float4*>(cur)[q];
#pragma unroll
      for (int k = 1; k < kMaxPlanes; ++k)
        if (k < n_in)
          s = add4(s, reinterpret_cast<const float4*>(cur + k * chunk)[q]);
      float4 t = s;
      for (int i = 0; i < chain; ++i) {
        t.x = t.x * mul + s.x;
        t.y = t.y * mul + s.y;
        t.z = t.z * mul + s.z;
        t.w = t.w * mul + s.w;
      }
      reinterpret_cast<float4*>(out + c * chunk)[q] = t;
    }
    __syncthreads();  // this stage is refilled by the next iteration
    stage ^= 1;
  }
  cp_async_wait_group<0>();
}

// ---------------------------------------------------------------- flips

__device__ __forceinline__ uint32_t tf32_bits(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
  return r;
}

// A01[k][n] = 1 where k and n differ in exactly one of bits 0-6.
__device__ __forceinline__ uint32_t adjacency(int k, int n) {
  const int d = k ^ n;
  return (d != 0 && (d & (d - 1)) == 0) ? kOneTf32 : 0u;
}

// out[i] = x[i] + sum_{lo <= j < hi} x[i ^ 2^j], the terms added in
// ascending j.  The gather and shuffle variants; the tile and MMA variants
// are the TMA kernels below (probe_flipsum_tile_kernel,
// probe_flipsum_mma_kernel).  kShfl: block b owns elements [b 2^tile_bits,
// ...), loads them into shared memory, and sums bits 0-4 by warp shuffles,
// the rest of the tile from shared memory and the bits above from global
// memory.
template <int V>
__global__ void __launch_bounds__(kThreads)
    probe_flipsum_kernel(const float* __restrict__ x, float* __restrict__ out,
                         int64_t n, int lo, int hi, int tile_bits) {
  if constexpr (V == kGather) {
    const int64_t stride = int64_t(gridDim.x) * blockDim.x;
    for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      float y[kMaxFlipBits];
#pragma unroll
      for (int c = 0; c < kMaxFlipBits; ++c)
        if (lo + c < hi) y[c] = x[i ^ (int64_t(1) << (lo + c))];
      float acc = x[i];
#pragma unroll
      for (int c = 0; c < kMaxFlipBits; ++c)
        if (lo + c < hi) acc += y[c];
      out[i] = acc;
    }
  } else {
    extern __shared__ __align__(16) unsigned char smem[];
    float* tile = reinterpret_cast<float*>(smem);
    const int tn = 1 << tile_bits;
    const int64_t base = int64_t(blockIdx.x) << tile_bits;
    for (int q = threadIdx.x; q < (tn >> 2); q += blockDim.x)
      cp_async16(tile + 4 * q, x + base + 4 * q);
    cp_async_wait_all();
    __syncthreads();
    const int mid = hi < tile_bits ? hi : tile_bits;
    const int g0 = lo > tile_bits ? lo : tile_bits;
    for (int k = threadIdx.x; k < tn; k += blockDim.x) {
      const int64_t i = base + k;
      const float v = tile[k];
      float acc = v;
      int j = lo;
      for (; j < mid && j < 5; ++j)
        acc += __shfl_xor_sync(0xffffffffu, v, 1 << j);
      for (; j < mid; ++j) acc += tile[k ^ (1 << j)];
      // bits above the tile: partners in other tiles, all loads of an
      // element in flight before the first is added
      float y[kMaxFlipBits];
#pragma unroll
      for (int c = 0; c < kMaxFlipBits; ++c)
        if (g0 + c < hi) y[c] = x[i ^ (int64_t(1) << (g0 + c))];
#pragma unroll
      for (int c = 0; c < kMaxFlipBits; ++c)
        if (g0 + c < hi) acc += y[c];
      out[i] = acc;
    }
  }
}

// ------------------------------------------------------------ tile MMA

// The TF32, 3xTF32 and FP64 products below share one pipeline.  A
// persistent block (one an SM) holds M in shared memory for its whole
// life, in the layout its
// MMA reads, and walks the tiles blockIdx.x, + gridDim.x, ... of x.  One
// producer thread streams those tiles through a ring of stages (as many
// as shared memory holds beside M) with TMA bulk copies (cp.async.bulk,
// completed on the stage's `full` mbarrier); two consumer groups of four
// warps take the block's tiles in turn (group i % 2 the i-th), read their
// A fragments from the stage, free it on its `empty` mbarrier and store
// their results.  A ragged last tile is copied and stored only as far as
// R.  The loads of later tiles are in flight under the MMAs and the stores
// of earlier ones.
constexpr int kPipeThreads = 288;  // 8 consumer warps + 1 producer warp
constexpr int kProducerWarp = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// `bytes` (a multiple of 16) from global to shared memory by the TMA unit,
// counted against `bar`'s expected transaction bytes.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void consumers_sync() {  // the 8 consumer warps
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void group_sync(int group) {  // one group's 4 warps
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + group) : "memory");
}
// `bytes` from shared to global memory by the TMA unit, as one bulk group
// of the calling thread (cp.async.bulk.wait_group waits for it).
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

// Barriers: full[s] (one arrival, the producer's, plus the stage's bytes)
// and empty[s] (one arrival from each of the `readers` warps that read it:
// the 4 of a consumer group, or all 8 where every warp reads every stage).
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages, int readers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], readers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer: tile i of this block goes into stage i % stages once
// the warps that read the stage's previous tile have freed it.  Tiles of
// `tile_rows` rows of `row_bytes`, copied as one block of rows (stride
// 0) or one copy a row into rows `stride` bytes apart.
__device__ __forceinline__ void produce(const unsigned char* x,
                                        unsigned char* ring, int stage_bytes,
                                        int stride, uint64_t* full,
                                        uint64_t* empty, int64_t rows,
                                        int tile_rows, int row_bytes,
                                        int stages) {
  const int64_t n_tiles = (rows + tile_rows - 1) / tile_rows;
  int64_t i = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
    const int s = int(i % stages);
    mbar_wait(&empty[s], uint32_t((i / stages) & 1) ^ 1u);
    const int64_t r0 = tile * tile_rows;
    const int n = int(rows - r0 < tile_rows ? rows - r0 : tile_rows);
    mbar_expect_tx(&full[s], uint32_t(n * row_bytes));
    unsigned char* dst = ring + int64_t(s) * stage_bytes;
    const unsigned char* src = x + r0 * row_bytes;
    if (stride == 0)
      bulk_load(dst, src, uint32_t(n * row_bytes), &full[s]);
    else
      for (int r = 0; r < n; ++r)
        bulk_load(dst + r * stride, src + int64_t(r) * row_bytes,
                  uint32_t(row_bytes), &full[s]);
  }
}

// M (128 x 128, row-major) into shared memory by the 256 consumer threads:
// `put(e, v)` stores element e.  kMBatch loads a thread are in flight
// before the first store (one at a time, the 64 round trips to L2 held the
// first tile back).
constexpr int kMBatch = 32;
template <typename T, typename Put>
__device__ __forceinline__ void load_m(const T* __restrict__ m, Put put) {
  for (int e0 = threadIdx.x; e0 < 128 * 128; e0 += 256 * kMBatch) {
    T v[kMBatch];
#pragma unroll
    for (int q = 0; q < kMBatch; ++q) v[q] = __ldg(m + e0 + 256 * q);
#pragma unroll
    for (int q = 0; q < kMBatch; ++q) put(e0 + 256 * q, v[q]);
  }
}

// A consumer's wait for tile i of its block; returns the tile's stage.  A
// parity wait cannot tell phase k + 1 from phase k - 1, and the other
// group may run a whole ring ahead (the TMA unit completes copies out of
// order), so the wait for fill k of a stage first waits, as the producer
// did, until fill k - 1 was read: the full barrier is then in phase k.
template <int Stages>
__device__ __forceinline__ int consume_wait(uint64_t* full, uint64_t* empty,
                                            int64_t i) {
  const int s = int(i % Stages);
  const uint32_t k = uint32_t((i / Stages) & 1);
  mbar_wait(&empty[s], k ^ 1u);
  mbar_wait(&full[s], k);
  return s;
}

// ---- TF32: wgmma m64n128k8, A from registers, B (M) from shared memory

constexpr int kTf32TileRows = 64;
constexpr int kTf32Stages = 3;
constexpr int kTf32MBytes = 128 * 128 * 4;
constexpr int kTf32StageBytes = kTf32TileRows * 128 * 4;
constexpr int kTf32Smem = kTf32MBytes + (kTf32Stages + 2) * kTf32StageBytes +
                          2 * kTf32Stages * 8;
// 3xTF32: M's hi and lo parts and the ring fill 224 KB, no output buffers
constexpr int k3xTf32Smem =
    2 * kTf32MBytes + kTf32Stages * kTf32StageBytes + 2 * kTf32Stages * 8;
static_assert(k3xTf32Smem <= kMaxSmem, "3xTF32 shared memory");

// D (64 x 128, f32) += A (64 x 8, TF32, registers) B (8 x 128, TF32, the
// shared-memory matrix `desc` describes).  D of warp w of the warpgroup,
// n-tile j: d[4j] (16w+g, 8j+2t), d[4j+1] (16w+g, 8j+2t+1), d[4j+2]
// (16w+g+8, 8j+2t), d[4j+3] (16w+g+8, 8j+2t+1); A: a0 (16w+g, t), a1
// (16w+g+8, t), a2 (16w+g, t+4), a3 (16w+g+8, t+4).
#define QP_D8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),      \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : QP_D8(0), QP_D8(8), QP_D8(16), QP_D8(24), QP_D8(32), QP_D8(40),
        QP_D8(48), QP_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
#undef QP_D8

// The TF32 kernel's k order.  Step ks's hardware k index p (t or t + 4 in
// a thread's A fragment) reads x's column 16 (ks / 2) + 4 (p % 4) +
// 2 (ks % 2) + p / 4, so that a thread's four columns 16 s + 4 t .. + 3
// are one float4 load serving steps 2s and 2s+1.  B is stored in the same
// order, so the product is x M.  Returns 8 ks + p of column `k`.
__device__ __forceinline__ int tf32_hw_k(int k) {
  const int ks = ((k >> 4) << 1) + ((k >> 1) & 1);
  const int p = ((k >> 2) & 3) + ((k & 1) << 2);
  return (ks << 3) + p;
}

// M as wgmma's B operand: K-major (B must be K-major for TF32), no
// swizzle.  Core matrices of 8 n-rows x 4 k (16 B a row, 128 B) at byte
// (n / 8) * 4096 + (kp / 4) * 128: the leading (k) byte offset is 128, the
// stride (n) byte offset 4096, and step ks starts 256 ks bytes in.
__device__ __forceinline__ uint64_t tf32_b_desc(const float* b, int ks) {
  const uint32_t addr = smem_addr(b) + uint32_t(ks) * 256u;
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) |
         (uint64_t(4096 >> 4) << 32);
}

// wgmma reads its A and D registers asynchronously: every write to them
// must come before the wgmma.fence that precedes the MMAs.  The compiler
// sees no tie between a register and the fence and may sink a conversion
// or a zero fill past it; these empty statements mark the values complete
// where they stand.
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]));
}
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int q = 0; q < 64; q += 8)
    asm volatile(""
                 : "+f"(d[q]), "+f"(d[q + 1]), "+f"(d[q + 2]), "+f"(d[q + 3]),
                   "+f"(d[q + 4]), "+f"(d[q + 5]), "+f"(d[q + 6]),
                   "+f"(d[q + 7]));
}

// Fragment value v: its TF32 rounding in `hi` and, with Split, the TF32
// rounding of the remainder v - hi (exact in f32) in `lo`.
template <bool Split>
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(v);
  if constexpr (Split) lo = tf32_bits(v - __uint_as_float(hi));
}

// The A fragments of k-steps 0 .. N-1 from a thread's row pair of a stage
// (`xs` at its row 16w+g, column 4t; row 16w+g+8 is 1024 floats on): the
// float4 of columns 16q + 4t .. + 3 of each row feeds steps 2q and 2q+1
// (tf32_hw_k's order), split as tf32_split does.
template <bool Split, int N>
__device__ __forceinline__ void tile_fragments(const float* xs,
                                               uint32_t (&a)[N][4],
                                               uint32_t (&al)[N][4]) {
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const float4 r0 = *reinterpret_cast<const float4*>(xs + 16 * q);
    const float4 r8 = *reinterpret_cast<const float4*>(xs + 1024 + 16 * q);
    tf32_split<Split>(r0.x, a[2 * q][0], al[2 * q][0]);
    tf32_split<Split>(r8.x, a[2 * q][1], al[2 * q][1]);
    tf32_split<Split>(r0.y, a[2 * q][2], al[2 * q][2]);
    tf32_split<Split>(r8.y, a[2 * q][3], al[2 * q][3]);
    tf32_split<Split>(r0.z, a[2 * q + 1][0], al[2 * q + 1][0]);
    tf32_split<Split>(r8.z, a[2 * q + 1][1], al[2 * q + 1][1]);
    tf32_split<Split>(r0.w, a[2 * q + 1][2], al[2 * q + 1][2]);
    tf32_split<Split>(r8.w, a[2 * q + 1][3], al[2 * q + 1][3]);
  }
}

// out = x M for an (R, 128) f32 plane (R a multiple of 16), f32 sums.
// TF32 (Split = false): the operands rounded to TF32 (nearest, ties away).
// 3xTF32 (Split = true): each operand split into hi (its TF32 rounding)
// and lo (the TF32 rounding of the remainder), and per k-step the products
// lo Mhi, hi Mlo, then hi Mhi: the small terms first.
// Each consumer group is one warpgroup taking a whole 64-row tile.  TF32
// loads and rounds all of its A fragments (16 float4 loads a thread, 64
// registers), frees the stage, and runs 16 wgmma steps on them and M;
// 3xTF32 does so in two halves of 8 k-steps (24 wgmmas each) and keeps
// the stage.  TF32 writes the tile into the group's own 32 KB output
// buffer, from which one TMA bulk store sends it out (stores of 8 B a
// thread from registers, 8 rows an instruction, were slower).  3xTF32 has
// no room for those buffers beside M's two parts: it writes the tile back
// into its stage and stores it from there (4 % faster than from
// registers, tools/tile_mma_variants.py).  Shared memory: M 64 KB (hi and
// lo: 128 KB), the ring 3 x 32 KB, TF32's output buffers 2 x 32 KB.
template <bool Split>
__global__ void __launch_bounds__(kPipeThreads, 1)
    probe_tile_mma_tf32_kernel(const float* __restrict__ x,
                               const float* __restrict__ m,
                               float* __restrict__ out, int64_t rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* bs = reinterpret_cast<float*>(smem);  // M, or M's hi part
  float* bl = bs + 128 * 128;                  // Split: M's lo part
  unsigned char* ring = smem + (Split ? 2 : 1) * kTf32MBytes;
  float* obufs = reinterpret_cast<float*>(ring + kTf32Stages * kTf32StageBytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(Split ? obufs : obufs + 2 * 64 * 128);
  uint64_t* empty = full + kTf32Stages;
  init_ring(full, empty, kTf32Stages, 4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == kProducerWarp) {
    if (lane == 0)
      produce(reinterpret_cast<const unsigned char*>(x), ring,
              kTf32StageBytes, 0, full, empty, rows, kTf32TileRows, 512,
              kTf32Stages);
    return;
  }
  // M, rounded (and split) once, into the core-matrix layout (rows in
  // tf32_hw_k's order); made visible to the tensor cores' (async proxy)
  // reads
  load_m(m, [&](int e, float v) {
    const int n = e & 127, kp = tf32_hw_k(e >> 7);
    const int at = (n >> 3) * 1024 + (kp >> 2) * 32 + (n & 7) * 4 + (kp & 3);
    uint32_t hi, lo;
    tf32_split<Split>(v, hi, lo);
    bs[at] = __uint_as_float(hi);
    if constexpr (Split) bl[at] = __uint_as_float(lo);
  });
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();
  const int group = warp >> 2;
  const int w = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;  // issues the group's stores
  float* obuf = obufs + group * 64 * 128;
  const int64_t n_tiles = (rows + kTf32TileRows - 1) / kTf32TileRows;
  int64_t i = group;
  for (int64_t tile = blockIdx.x + int64_t(group) * gridDim.x; tile < n_tiles;
       tile += 2 * int64_t(gridDim.x), i += 2) {
    const int s = consume_wait<kTf32Stages>(full, empty, i);
    const float* xs = reinterpret_cast<const float*>(
        ring + s * kTf32StageBytes) + ((16 * w + g) << 7) + 4 * t;
    const int64_t r0 = tile * kTf32TileRows;
    float d[64];
#pragma unroll
    for (int q = 0; q < 64; ++q) d[q] = 0.f;
    if constexpr (Split) {
      // the k-steps in two halves of 8: a half's hi and lo fragments (64
      // registers) beside the accumulators leave ptxas room to keep its
      // 24 wgmmas in flight (all 16 k-steps at once did not fit: ptxas
      // serialized them, and results went wrong once a block took more
      // than one tile)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t a[8][4], al[8][4];
        tile_fragments<true, 8>(xs + 64 * h, a, al);
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          pin(a[ks]);
          pin(al[ks]);
        }
        pin(d);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          wgmma_tf32(d, al[ks], tf32_b_desc(bs, 8 * h + ks));
          wgmma_tf32(d, a[ks], tf32_b_desc(bl, 8 * h + ks));
          wgmma_tf32(d, a[ks], tf32_b_desc(bs, 8 * h + ks));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      }
    } else {
      uint32_t a[16][4], unused[16][4];
      tile_fragments<false, 16>(xs, a, unused);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int ks = 0; ks < 16; ++ks) pin(a[ks]);
      pin(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < 16; ++ks)
        wgmma_tf32(d, a[ks], tf32_b_desc(bs, ks));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      // the group's output buffer is free once its previous store has
      // read it
      if (leader)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      group_sync(group);
    }
    // the tile goes out through shared memory, one bulk store of its valid
    // rows: TF32's through the group's output buffer, 3xTF32's through the
    // stage it came in by (each warp writes its 16 rows back where it read
    // them), which is freed once that store has read it
    float* buf =
        Split ? reinterpret_cast<float*>(ring + s * kTf32StageBytes) : obuf;
    float* o = buf + ((16 * w + g) << 7) + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<float2*>(o + 8 * j) =
          make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(o + 1024 + 8 * j) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    group_sync(group);
    if (leader) {
      const int n = int(rows - r0 < kTf32TileRows ? rows - r0 : kTf32TileRows);
      bulk_store(out + (r0 << 7), buf, uint32_t(n * 512));
      if (Split)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    if constexpr (Split) {
      group_sync(group);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- flip sums through a TMA ring: probe_flipsum<tile> and <mma>

// The tile variant.  Block b walks a chunk of `per_block` consecutive
// stages of 2^stage_bits elements (stage_bits = tile_bits raised to 10,
// 256 float4s, one a consumer thread, and cut to the plane) through a
// ring of TMA bulk copies filled by one producer thread; its 8 consumer
// warps read every stage.  Partners of bits below stage_bits are read from
// the stage, those above from global memory.  A stage larger than the tile
// moves the partners of bits tile_bits .. stage_bits - 1 from global to
// shared memory; the terms and their order, and so the sum, are the same.
// Each thread makes a float4 of outputs q: bits 0-1 swap values inside its
// own float4, bit j >= 2 is one LDS.128 of float4 q ^ 2^(j-2) (a warp reads
// 512 contiguous bytes in some order: no bank conflicts), the bits above
// are float4 loads from global memory, all in flight before the first add;
// the sum runs in ascending j (bit for bit the plain version's); one
// STG.128 stores it.  The in-stage bit loop is unrolled to a fixed maximum
// and predicated on a mask of the bits wanted.  Bound: bytes (one read,
// one write).
constexpr int kFlipConsumers = 256;  // the 8 consumer warps
constexpr int kFlipStageMinBits = 10;
constexpr int kFlipStageMaxBits = 15;  // 128 KB: the largest tile accepted

// The partner of float4 q (value v) of a stage `s4` across bit j.
__device__ __forceinline__ float4 flip_partner(const float4* s4, int q,
                                               float4 v, int j) {
  if (j == 0) return make_float4(v.y, v.x, v.w, v.z);
  if (j == 1) return make_float4(v.z, v.w, v.x, v.y);
  return s4[q ^ (1 << (j - 2))];
}

// Above: some bit lies above the stage (hi > stage_bits).
template <bool Above>
__global__ void __launch_bounds__(kPipeThreads)
    probe_flipsum_tile_kernel(const float* __restrict__ x,
                              float* __restrict__ out, int64_t n, int lo,
                              int hi, int stage_bits, int stages,
                              int64_t per_block) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int stage_bytes = 4 << stage_bits;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  uint64_t* empty = full + stages;
  init_ring(full, empty, stages, kFlipConsumers / 32);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t n_tiles = n >> stage_bits;
  // this block's stages: first, first + step, ..., count of them (a chunk;
  // tools/flipsum_variants.py also times step = gridDim.x)
  const int64_t first = int64_t(blockIdx.x) * per_block;
  const int64_t step = 1;
  int64_t count = (n_tiles - first + step - 1) / step;
  if (count > per_block) count = per_block;
  if (warp == kProducerWarp) {
    if (lane == 0)
      for (int64_t i = 0; i < count; ++i) {
        const int s = int(i % stages);
        mbar_wait(&empty[s], uint32_t((i / stages) & 1) ^ 1u);
        mbar_expect_tx(&full[s], uint32_t(stage_bytes));
        bulk_load(smem + s * stage_bytes,
                  x + ((first + i * step) << stage_bits),
                  uint32_t(stage_bytes), &full[s]);
      }
    return;
  }
  const int mid = hi < stage_bits ? hi : stage_bits;
  const uint32_t in_stage =
      lo < mid ? ((1u << mid) - 1u) & ~((1u << lo) - 1u) : 0u;
  const int g0 = lo > stage_bits ? lo : stage_bits;  // first bit above
  const int n4 = 1 << (stage_bits - 2);
  for (int64_t i = 0; i < count; ++i) {
    // every warp reads every stage in order, so fill k - 1 of this stage
    // was read by this warp itself: its full barrier is in phase k
    const int s = int(i % stages);
    mbar_wait(&full[s], uint32_t((i / stages) & 1));
    const float4* s4 =
        reinterpret_cast<const float4*>(smem + s * stage_bytes);
    const int64_t base = (first + i * step) << stage_bits;
    for (int q = threadIdx.x; q < n4; q += kFlipConsumers) {
      const int64_t e = base + 4 * q;
      float4 far[Above ? kMaxFlipBits : 1];
      if constexpr (Above) {
#pragma unroll
        for (int c = 0; c < kMaxFlipBits; ++c)
          if (g0 + c < hi)
            far[c] = ld_stream(x + (e ^ (int64_t(1) << (g0 + c))));
      }
      const float4 v = s4[q];
      float4 acc = v;
#pragma unroll
      for (int j = 0; j < kFlipStageMaxBits; ++j)
        if ((in_stage >> j) & 1u) acc = add4(acc, flip_partner(s4, q, v, j));
      if constexpr (Above) {
#pragma unroll
        for (int c = 0; c < kMaxFlipBits; ++c)
          if (g0 + c < hi) acc = add4(acc, far[c]);
      }
      st_stream(out + e, acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// The MMA variant: probe_tile_mma_tf32_kernel<true>'s pipeline (one
// persistent block an SM walking the tiles blockIdx.x, + gridDim.x, ...,
// one producer thread, two consumer groups taking the block's tiles in
// turn) with B = A01 (exact in TF32, so no lo part: 64 KB) and a 4-stage
// ring of 64-row (2^13-element) tiles.  Bits 0-6 of a 64 x 128 tile are
// x_hi A01 + x_lo A01: per k-step the lo pass, then the hi pass, the 16
// k-steps in two halves of 8 as 3xTF32 runs them.  B's columns are stored
// in tf32_hw_n's order, so that the accumulator a thread holds for row r,
// n-tiles 2q and 2q + 1, is columns 16q + 4t .. + 3: the float4 its A
// fragment loads read.  The epilogue adds, per float4, x and the row
// partners of bits 7 .. 12 (rows r ^ 2^(j-7)) from the stage, then the
// bits above from global memory, and stores it (STG.128); each warp frees
// the stage once it has read its partners.  Sending the tile out through
// its stage with one TMA bulk store, as 3xTF32 does, was slower
// (tools/flipsum_variants.py): it holds the stage and the group until the
// store has read it.  The kernel stages 64 rows whatever tile_bits
// (11-14): with 11 or 12 the partners of bits 11-12 come from the stage,
// with 14 that of bit 13 from global memory; that changes where a partner
// is read, not the terms or their order.  Shared memory: A01 64 KB, the
// ring 4 x 32 KB.
constexpr int kFlipMmaStages = 4;
constexpr int kFlipMmaTileBits = 13;
constexpr int kFlipMmaMaxAbove = kMaxFlipBits - kFlipMmaTileBits;  // lo = 0
constexpr int kFlipMmaSmem =
    kTf32MBytes + kFlipMmaStages * kTf32StageBytes + 2 * kFlipMmaStages * 8;
static_assert(kFlipMmaSmem <= kMaxSmem, "flip-sum MMA shared memory");

// Column n of a 128-wide row as a hardware column of wgmma's B and D:
// n = 16q + 4t + c goes to n-tile 2q + c / 2, column 2t + c % 2 in it.
__device__ __forceinline__ int tf32_hw_n(int n) {
  return (n & ~15) + ((n & 2) << 2) + ((n >> 2) & 3) * 2 + (n & 1);
}

template <bool Above>
__global__ void __launch_bounds__(kPipeThreads, 1)
    probe_flipsum_mma_kernel(const float* __restrict__ x,
                             float* __restrict__ out, int64_t n, int hi) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* bs = reinterpret_cast<float*>(smem);  // A01
  unsigned char* ring = smem + kTf32MBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kFlipMmaStages * kTf32StageBytes);
  uint64_t* empty = full + kFlipMmaStages;
  init_ring(full, empty, kFlipMmaStages, 4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t rows = n >> 7;
  if (warp == kProducerWarp) {
    if (lane == 0)
      produce(reinterpret_cast<const unsigned char*>(x), ring,
              kTf32StageBytes, 0, full, empty, rows, kTf32TileRows, 512,
              kFlipMmaStages);
    return;
  }
  // A01 into the core-matrix layout, rows in tf32_hw_k's order, columns in
  // tf32_hw_n's; made visible to the tensor cores' (async proxy) reads
  for (int e = threadIdx.x; e < 128 * 128; e += 256) {
    const int k = e >> 7, kp = tf32_hw_k(k), nh = tf32_hw_n(e & 127);
    bs[(nh >> 3) * 1024 + (kp >> 2) * 32 + (nh & 7) * 4 + (kp & 3)] =
        __uint_as_float(adjacency(k, e & 127));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();
  const int group = warp >> 2;
  const int w = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r = 16 * w + g;  // the thread's rows r and r + 8 of a tile
  const int mid = hi < kFlipMmaTileBits ? hi : kFlipMmaTileBits;
  const uint32_t row_bits = mid > 7 ? (1u << (mid - 7)) - 1u : 0u;
  const int64_t n_tiles = (rows + kTf32TileRows - 1) / kTf32TileRows;
  int64_t i = group;
  for (int64_t tile = blockIdx.x + int64_t(group) * gridDim.x; tile < n_tiles;
       tile += 2 * int64_t(gridDim.x), i += 2) {
    const int s = consume_wait<kFlipMmaStages>(full, empty, i);
    const float* st =
        reinterpret_cast<const float*>(ring + s * kTf32StageBytes);
    const int64_t r0 = tile * kTf32TileRows;
    // rows of the tile in the plane: a multiple of 16 (the plane is a
    // power of two of at least 2^11 elements), so a warp's rows are all
    // in or all out
    const int valid =
        int(rows - r0 < kTf32TileRows ? rows - r0 : kTf32TileRows);
    float d[64];
#pragma unroll
    for (int q = 0; q < 64; ++q) d[q] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t a[8][4], al[8][4];
      tile_fragments<true, 8>(st + (r << 7) + 4 * t + 64 * h, a, al);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        pin(a[ks]);
        pin(al[ks]);
      }
      pin(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        wgmma_tf32(d, al[ks], tf32_b_desc(bs, 8 * h + ks));
        wgmma_tf32(d, a[ks], tf32_b_desc(bs, 8 * h + ks));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    }
    // the epilogue: d[8q + 4(c/2) + 2hr + c%2] is column 16q + 4t + c of
    // row r + 8hr
    if (16 * w < valid) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int rr = r + 8 * hr;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = 16 * q + 4 * t;
          const int64_t e = ((r0 + rr) << 7) + col;
          float4 far[Above ? kFlipMmaMaxAbove : 1];
          if constexpr (Above) {
#pragma unroll
            for (int c = 0; c < kFlipMmaMaxAbove; ++c)
              if (kFlipMmaTileBits + c < hi)
                far[c] = ld_stream(
                    x + (e ^ (int64_t(1) << (kFlipMmaTileBits + c))));
          }
          const float4 v =
              *reinterpret_cast<const float4*>(st + (rr << 7) + col);
          const float* dq = d + 8 * q + 2 * hr;
          float4 acc = make_float4(v.x + dq[0], v.y + dq[1], v.z + dq[4],
                                   v.w + dq[5]);
#pragma unroll
          for (int b = 0; b < kFlipMmaTileBits - 7; ++b)
            if ((row_bits >> b) & 1u)
              acc = add4(acc, *reinterpret_cast<const float4*>(
                                  st + ((rr ^ (1 << b)) << 7) + col));
          if constexpr (Above) {
#pragma unroll
            for (int c = 0; c < kFlipMmaMaxAbove; ++c)
              if (kFlipMmaTileBits + c < hi) acc = add4(acc, far[c]);
          }
          st_stream(out + e, acc);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// ---- FP64: mma.sync m16n8k16, both operands from shared memory

constexpr int kF64TileRows = 32;
constexpr int kF64Stages = 3;
constexpr int kF64Stride = 130;  // doubles a row of a stage: 1040 B
constexpr int kF64MBytes = 128 * 128 * 8;
constexpr int kF64StageBytes = kF64TileRows * kF64Stride * 8;
constexpr int kF64Smem =
    kF64MBytes + kF64Stages * kF64StageBytes + 2 * kF64Stages * 8;

// D (16 x 8) += A (16 x 16) B (16 x 8), f64.  Fragments: a[2j] (g, 4j+t),
// a[2j+1] (g+8, 4j+t); b[j] (4j+t, g); d0 (g, 2t), d1 (g, 2t+1), d2 (g+8,
// 2t), d3 (g+8, 2t+1).
__device__ __forceinline__ void mma_f64_k16(double (&d)[4],
                                            const double (&a)[8],
                                            const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// out = x M in f64 for an (R, 128) plane (R a multiple of 8).  A consumer
// group takes a 32-row tile, each warp a 32 x 32 block of it (2 x 4 tiles
// of 16 x 8, 32 doubles of accumulator a thread).  The k order: hardware
// index 4j + t of step ks (K = 16) reads column 16 ks + 4t + j, so a
// thread's A values of a row are two double2 loads; M is stored in
// fragment order, b[0..3] of (ks, n-tile) as two double2 a lane, 512 B a
// warp per load.  Stage rows are 1040 B apart (one bulk copy a row): the
// 8 rows of an A load then fall on distinct banks.  A group holds its
// stage until its MMAs have read it.  Shared memory: M 128 KB and 3 stages of 32.5 KB, 225.5 KB of
// the 227 a block may have, so the results go out from registers, 16 B a
// thread (two adjacent doubles).
__global__ void __launch_bounds__(kPipeThreads, 1)
    probe_tile_mma_f64_kernel(const double* __restrict__ x,
                              const double* __restrict__ m,
                              double* __restrict__ out, int64_t rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  double2* bs = reinterpret_cast<double2*>(smem);
  unsigned char* ring = smem + kF64MBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + kF64Stages * kF64StageBytes);
  uint64_t* empty = full + kF64Stages;
  init_ring(full, empty, kF64Stages, 4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == kProducerWarp) {
    if (lane == 0)
      produce(reinterpret_cast<const unsigned char*>(x), ring,
              kF64StageBytes, kF64Stride * 8, full, empty, rows,
              kF64TileRows, 1024, kF64Stages);
    return;
  }
  // M[k][n] is b[k % 4] of lane 4 (n % 8) + (k % 16) / 4 in (k / 16, n / 8)
  load_m(m, [&](int e, double v) {
    const int k = e >> 7, n = e & 127;
    const int lb = ((n & 7) << 2) + ((k & 15) >> 2);
    const int j = k & 3;
    reinterpret_cast<double*>(
        bs + ((((k >> 4) << 4) + (n >> 3)) * 2 + (j >> 1)) * 32 + lb)[j & 1] =
        v;
  });
  consumers_sync();
  const int group = warp >> 2;
  const int wn = (warp & 3) * 4;  // the warp's first n-tile
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t n_tiles = (rows + kF64TileRows - 1) / kF64TileRows;
  int64_t i = group;
  for (int64_t tile = blockIdx.x + int64_t(group) * gridDim.x; tile < n_tiles;
       tile += 2 * int64_t(gridDim.x), i += 2) {
    const int s = consume_wait<kF64Stages>(full, empty, i);
    const double* xs = reinterpret_cast<const double*>(
        ring + s * kF64StageBytes) + g * kF64Stride + 4 * t;
    double acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][nt][q] = 0.0;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      double av[4][4];  // rows g + 8 r, columns 16 ks + 4t + j
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const double2 v0 = *reinterpret_cast<const double2*>(
            xs + 8 * r * kF64Stride + 16 * ks);
        const double2 v1 = *reinterpret_cast<const double2*>(
            xs + 8 * r * kF64Stride + 16 * ks + 2);
        av[r][0] = v0.x;
        av[r][1] = v0.y;
        av[r][2] = v1.x;
        av[r][3] = v1.y;
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const double2* bp = bs + ((ks << 4) + wn + nt) * 64 + lane;
        const double2 b01 = bp[0];
        const double2 b23 = bp[32];
        const double b[4] = {b01.x, b01.y, b23.x, b23.y};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const double a[8] = {av[2 * mi][0], av[2 * mi + 1][0],
                               av[2 * mi][1], av[2 * mi + 1][1],
                               av[2 * mi][2], av[2 * mi + 1][2],
                               av[2 * mi][3], av[2 * mi + 1][3]};
          mma_f64_k16(acc[mi][nt], a, b);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    const int64_t r0 = tile * kF64TileRows + g;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = r0 + 16 * mi + 8 * h;
        if (r < rows) {  // R is a multiple of 8: 8-row blocks in or out
          double* o = out + (r << 7) + 2 * t;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            *reinterpret_cast<double2*>(o + 8 * (wn + nt)) = make_double2(
                acc[mi][nt][2 * h], acc[mi][nt][2 * h + 1]);
        }
      }
  }
}

// ----------------------------------------------------------- shared memory

__global__ void __launch_bounds__(kThreads)
    probe_smem_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int n, int bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* top = reinterpret_cast<float*>(smem) + (bytes / 4 - n);
  for (int k = threadIdx.x; k < n; k += blockDim.x) top[k] = x[k];
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += blockDim.x) out[k] = top[k] * 2.0f;
}

// ------------------------------------------------------------ flip order

// cheby_flip_tiled<double, false> of csrc/cheby_flip.cu with the body and
// the cross-tile partner reads made template choices:
//   full:     u = dmb x + sum_{j<bits} G_j x[nb_j(i)] + w,
//             out = v0 + i s u, Phi += a out;
//   noflips:  the same without the in-tile terms (j < tile_bits);
//   copy:     u = x + dmb + sum_{tile_bits <= j < bits} x[nb_j(i)] + w,
//             out = v0 + u, Phi += out (the same streams, summed);
// nb_j(i) = i ^ 2^j (xor) or i (self); with none no partner above the tile
// is read.
template <int Body, int Nb>
__global__ void __launch_bounds__(kOrderThreads)
    probe_flip_order_kernel(const double2* v0, double2* out,
                            const double2* __restrict__ x,
                            double2* __restrict__ phi,
                            const double* __restrict__ dmb,
                            const double* __restrict__ G,
                            const double2* __restrict__ w, int tile_bits,
                            int bits, double s, double a) {
  extern __shared__ __align__(16) unsigned char smem[];
  double2* tile = reinterpret_cast<double2*>(smem);
  __shared__ double sG[kMaxBits];
  const int tn = 1 << tile_bits;
  const int64_t base = int64_t(blockIdx.x) << tile_bits;
  for (int k = threadIdx.x; k < tn; k += blockDim.x)
    cp_async16(tile + k, x + base + k);
  if (int(threadIdx.x) < bits) sG[threadIdx.x] = G[threadIdx.x];
  cp_async_wait_all();
  __syncthreads();
  const int lo = bits < tile_bits ? bits : tile_bits;
  const int hi = Nb == kNbNone ? lo : bits;
  for (int k = threadIdx.x; k < tn; k += blockDim.x) {
    const int64_t i = base + k;
    const double d = dmb[i];
    const double2 x0 = v0[i];
    double2 p = phi[i];
    double2 z = make_double2(0.0, 0.0);
    if (w != nullptr) z = w[i];
    const double2 xi = tile[k];
    double ur, ui;
    if constexpr (Body == kCopy) {
      ur = xi.x + d;
      ui = xi.y;
    } else {
      ur = d * xi.x;
      ui = d * xi.y;
    }
    if constexpr (Body == kFull) {
#pragma unroll 4
      for (int j = 0; j < lo; ++j) {
        const double2 y = tile[k ^ (1 << j)];
        ur += sG[j] * y.x;
        ui += sG[j] * y.y;
      }
    }
    constexpr int batch = 4;
    for (int j0 = lo; j0 < hi; j0 += batch) {
      double2 y[batch];
#pragma unroll
      for (int c = 0; c < batch; ++c)
        if (j0 + c < hi)
          y[c] = x[Nb == kNbXor ? (i ^ (int64_t(1) << (j0 + c))) : i];
#pragma unroll
      for (int c = 0; c < batch; ++c)
        if (j0 + c < hi) {
          if constexpr (Body == kCopy) {
            ur += y[c].x;
            ui += y[c].y;
          } else {
            ur += sG[j0 + c] * y[c].x;
            ui += sG[j0 + c] * y[c].y;
          }
        }
    }
    ur += z.x;
    ui += z.y;
    double2 r;
    if constexpr (Body == kCopy) {
      r.x = x0.x + ur;
      r.y = x0.y + ui;
      p.x += r.x;
      p.y += r.y;
    } else {
      r.x = x0.x - s * ui;
      r.y = x0.y + s * ur;
      p.x += a * r.x;
      p.y += a * r.y;
    }
    out[i] = r;
    phi[i] = p;
  }
}

template <int Body, int Nb>
int launch_order(const void* v0, void* out, const void* x, void* phi,
                 const void* dmb, const void* G, const void* w,
                 int tile_bits, int bits, int64_t n, double s2, double ak,
                 cudaStream_t stream) {
  const int bytes = (1 << tile_bits) * int(sizeof(double2));
  static int granted = 0;
  const cudaError_t rc =
      allow_smem(probe_flip_order_kernel<Body, Nb>, bytes, granted);
  if (rc != cudaSuccess) return int(rc);
  probe_flip_order_kernel<Body, Nb>
      <<<int(n >> tile_bits), kOrderThreads, bytes, stream>>>(
          (const double2*)v0, (double2*)out, (const double2*)x,
          (double2*)phi, (const double*)dmb, (const double*)G,
          (const double2*)w, tile_bits, bits, s2, ak);
  return int(cudaGetLastError());
}

template <int Body>
int launch_order_nb(int nb, const void* v0, void* out, const void* x,
                    void* phi, const void* dmb, const void* G, const void* w,
                    int tile_bits, int bits, int64_t n, double s2, double ak,
                    cudaStream_t stream) {
  switch (nb) {
    case kNbXor:
      return launch_order<Body, kNbXor>(v0, out, x, phi, dmb, G, w,
                                        tile_bits, bits, n, s2, ak, stream);
    case kNbSelf:
      return launch_order<Body, kNbSelf>(v0, out, x, phi, dmb, G, w,
                                         tile_bits, bits, n, s2, ak, stream);
    case kNbNone:
      return launch_order<Body, kNbNone>(v0, out, x, phi, dmb, G, w,
                                         tile_bits, bits, n, s2, ak, stream);
  }
  return int(cudaErrorInvalidValue);
}

// ------------------------------------------------------------ exactness

template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b);
template <>
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
template <>
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
template <typename T>
__device__ __forceinline__ T sub_rn(T a, T b);
template <>
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
template <>
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

enum FmaVariant { kInline = 0, kSeparate = 1, kLoaded = 2 };

// p = a*b; r = a*b - p.  Written plainly (kInline, the TPU probe's body)
// the compiler may contract a*b - p into fma(a, b, -p), the exact
// residual, or evaluate a*b once, which makes r = 0 whatever it does with
// a*b - p (nvcc does not fuse a product that is also stored).  kLoaded
// reads a, b and p back through volatile loads, so the second a*b is a
// product of its own with one use, and r is the residual exactly when
// a*b - p is contracted.  With the _rn intrinsics (kSeparate) every
// operation rounds on its own.
template <typename T, int Variant>
__global__ void __launch_bounds__(kThreads)
    probe_fma_residual_kernel(const T* __restrict__ a,
                              const T* __restrict__ b, T* __restrict__ p,
                              T* __restrict__ r, int64_t n) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T x = a[i];
    const T y = b[i];
    if constexpr (Variant == kSeparate) {
      const T q = mul_rn(x, y);
      p[i] = q;
      r[i] = sub_rn(mul_rn(x, y), q);
    } else if constexpr (Variant == kLoaded) {
      p[i] = x * y;
      const T x2 = *reinterpret_cast<volatile const T*>(a + i);
      const T y2 = *reinterpret_cast<volatile const T*>(b + i);
      const T q = *reinterpret_cast<volatile const T*>(p + i);
      r[i] = x2 * y2 - q;
    } else {
      const T q = x * y;
      p[i] = q;
      r[i] = x * y - q;
    }
  }
}

template <typename T>
int launch_fma(const void* a, const void* b, void* p, void* r, int variant,
               int64_t n, cudaStream_t stream) {
  if (n < 1) return int(cudaErrorInvalidValue);
  const int blocks = grid_for(n, kThreads);
  switch (variant) {
    case kInline:
      probe_fma_residual_kernel<T, kInline><<<blocks, kThreads, 0, stream>>>(
          (const T*)a, (const T*)b, (T*)p, (T*)r, n);
      break;
    case kSeparate:
      probe_fma_residual_kernel<T, kSeparate>
          <<<blocks, kThreads, 0, stream>>>((const T*)a, (const T*)b, (T*)p,
                                            (T*)r, n);
      break;
    case kLoaded:
      probe_fma_residual_kernel<T, kLoaded><<<blocks, kThreads, 0, stream>>>(
          (const T*)a, (const T*)b, (T*)p, (T*)r, n);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// One block: sigma = 64 max|x| over all n elements, then q = (sigma + x) -
// sigma and r = x - q, which no IEEE-conforming compilation folds.
__global__ void __launch_bounds__(kThreads)
    probe_extract_kernel(const float* __restrict__ x, float* __restrict__ q,
                         float* __restrict__ r, int n) {
  __shared__ float red[kThreads];
  float m = 0.f;
  for (int k = threadIdx.x; k < n; k += blockDim.x) m = fmaxf(m, fabsf(x[k]));
  red[threadIdx.x] = m;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (int(threadIdx.x) < h)
      red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + h]);
    __syncthreads();
  }
  const float sigma = 64.0f * red[0];
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float v = x[k];
    const float q1 = (sigma + v) - sigma;
    q[k] = q1;
    r[k] = v - q1;
  }
}

// out[i] = x[i ^ 2^bit]: V = 0 by a warp shuffle (bit < 5; n a multiple of
// 32, so every warp is whole), V = 1 through a tile of kPermTile elements.
template <int V>
__global__ void __launch_bounds__(kThreads)
    probe_xor_permute_kernel(const float* __restrict__ x,
                             float* __restrict__ out, int64_t n, int bit) {
  if constexpr (V == 0) {
    const int64_t stride = int64_t(gridDim.x) * blockDim.x;
    for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += stride)
      out[i] = __shfl_xor_sync(0xffffffffu, x[i], 1 << bit);
  } else {
    __shared__ __align__(16) float tile[kPermTile];
    const int64_t base = int64_t(blockIdx.x) * kPermTile;
    for (int k = threadIdx.x; k < kPermTile; k += blockDim.x)
      tile[k] = x[base + k];
    __syncthreads();
    for (int k = threadIdx.x; k < kPermTile; k += blockDim.x)
      out[base + k] = tile[k ^ (1 << bit)];
  }
}

// probe_stream's arguments, as its C entry checked them.
struct StreamArgs {
  Planes p;
  float* o1;
  float* o2;
  int n_in;
  int64_t n4;
  int tile_bits;
  int64_t n_tiles;
  int chain;
  float mul;
  float scale;
  cudaStream_t st;
};

// The kernel for this body, map and output count, one block a chunk.
template <int Op, int MaxIn, int U, bool Mapped, bool Half>
int launch_stream_kernel(const StreamArgs& a) {
  const int64_t n_chunks = (a.n4 + kThreads * U - 1) / (kThreads * U);
  const int blocks = int(n_chunks);
  probe_stream_kernel<Op, MaxIn, U, Mapped, Half>
      <<<blocks, kThreads, 0, a.st>>>(a.p, a.o1, a.o2, a.n_in, a.n4,
                                      a.tile_bits, a.n_tiles, a.chain, a.mul,
                                      a.scale);
  return int(cudaGetLastError());
}
template <int Op, int MaxIn, int U>
int launch_stream(const StreamArgs& a, bool mapped) {
  const bool half = a.o2 != nullptr;  // only kSum has it
  if (mapped)
    return half ? launch_stream_kernel<Op, MaxIn, U, true, Op == kSum>(a)
                : launch_stream_kernel<Op, MaxIn, U, true, false>(a);
  return half ? launch_stream_kernel<Op, MaxIn, U, false, Op == kSum>(a)
              : launch_stream_kernel<Op, MaxIn, U, false, false>(a);
}

// One persistent block an SM (at most one a tile).
template <bool Split>
int launch_tile_mma_tf32(const void* x, const void* m, void* out,
                         int64_t rows, cudaStream_t st) {
  constexpr int bytes = Split ? k3xTf32Smem : kTf32Smem;
  static int granted = 0;  // one per instantiation
  const cudaError_t rc =
      allow_smem(probe_tile_mma_tf32_kernel<Split>, bytes, granted);
  if (rc != cudaSuccess) return int(rc);
  const int64_t tiles = (rows + kTf32TileRows - 1) / kTf32TileRows;
  const int blocks = int(tiles < sm_count() ? tiles : sm_count());
  probe_tile_mma_tf32_kernel<Split><<<blocks, kPipeThreads, bytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(m),
      static_cast<float*>(out), rows);
  return int(cudaGetLastError());
}

// The tile variant's chunks and ring: kFlipTilesPerBlock stages a block,
// through a ring of kFlipStages (fewer where they do not fit), the grid
// as large as the chunks; the card schedules the blocks.  One stage a
// block streams at the rate of copy_: seven blocks an SM keep the loads in
// flight, and chunks of 2 or 4 stages through rings of 2 or 3, or
// persistent blocks through 7, were 1-16 % slower
// (tools/flipsum_variants.py varies these two constants).
constexpr int kFlipTilesPerBlock = 1;
constexpr int kFlipStages = 1;
template <bool Above>
int launch_flipsum_tile(const float* x, float* out, int64_t n, int lo,
                        int hi, int stage_bits, cudaStream_t st) {
  const int stage_bytes = 4 << stage_bits;
  const int barrier_bytes = 16;  // a stage's full and empty barriers
  const int64_t per_block = kFlipTilesPerBlock;
  int stages = kFlipStages;
  if (stages > kMaxSmem / (stage_bytes + barrier_bytes))
    stages = kMaxSmem / (stage_bytes + barrier_bytes);
  const int bytes = stages * (stage_bytes + barrier_bytes);
  static int granted = 0;  // one per instantiation
  cudaError_t rc =
      allow_smem(probe_flipsum_tile_kernel<Above>, bytes, granted);
  if (rc != cudaSuccess) return int(rc);
  static bool carved = false;  // blocks an SM by shared memory, not L1
  if (!carved) {
    rc = cudaFuncSetAttribute(probe_flipsum_tile_kernel<Above>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
    if (rc != cudaSuccess) return int(rc);
    carved = true;
  }
  const int64_t tiles = n >> stage_bits;
  const int blocks = int((tiles + per_block - 1) / per_block);
  probe_flipsum_tile_kernel<Above><<<blocks, kPipeThreads, bytes, st>>>(
      x, out, n, lo, hi, stage_bits, stages, per_block);
  return int(cudaGetLastError());
}

// One persistent block an SM (at most one a tile).
template <bool Above>
int launch_flipsum_mma(const float* x, float* out, int64_t n, int hi,
                       cudaStream_t st) {
  static int granted = 0;  // one per instantiation
  const cudaError_t rc =
      allow_smem(probe_flipsum_mma_kernel<Above>, kFlipMmaSmem, granted);
  if (rc != cudaSuccess) return int(rc);
  const int64_t tiles = ((n >> 7) + kTf32TileRows - 1) / kTf32TileRows;
  const int blocks = int(tiles < sm_count() ? tiles : sm_count());
  probe_flipsum_mma_kernel<Above>
      <<<blocks, kPipeThreads, kFlipMmaSmem, st>>>(x, out, n, hi);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  Each returns the CUDA error of its
// launch (0 on success), or cudaErrorInvalidValue for arguments it refuses.
extern "C" {

int probe_stream(const void* planes, void* o1, void* o2, int op, int n_in,
                 int64_t n, int tile_bits, int chain, float mul, float scale,
                 void* stream) {
  const Planes& p = *static_cast<const Planes*>(planes);
  if (n_in < 1 || n_in > kMaxPlanes || n < 4 || (n & 3) != 0 ||
      tile_bits < 2 || tile_bits > 40 || chain < 0 ||
      (op == kTriad && n_in != 3) || (op == kChain && n_in != 2) ||
      op < kSum || op > kChain || o1 == nullptr ||
      (reinterpret_cast<uintptr_t>(o1) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(o2) & 15) != 0 ||
      (o2 != nullptr && op != kSum))
    return int(cudaErrorInvalidValue);
  const int64_t n_tiles = n >> tile_bits;
  if (n_tiles < 1 || (n_tiles << tile_bits) != n || !planes_ok(p, n_in, n_tiles))
    return int(cudaErrorInvalidValue);
  bool mapped = false;
  for (int k = 0; k < n_in; ++k) mapped = mapped || p.kind[k] != kSelf;
  const StreamArgs a{p,     static_cast<float*>(o1), static_cast<float*>(o2),
                     n_in,  n >> 2, tile_bits,       n_tiles,
                     chain, mul,    scale,           (cudaStream_t)stream};
  if (n_in > 4) return launch_stream<kSum, kMaxPlanes, 1>(a, mapped);
  if (op == kTriad) return launch_stream<kTriad, 3, 1>(a, mapped);
  if (op == kChain) return launch_stream<kChain, 2, 1>(a, mapped);
  if (n_in == 1) return launch_stream<kSum, 1, 1>(a, mapped);
  if (n_in == 2) return launch_stream<kSum, 2, 1>(a, mapped);
  return launch_stream<kSum, 4, 1>(a, mapped);
}

int probe_stream_pipelined(const void* planes, void* out, int n_in, int64_t n,
                           int chunk, int chain, float mul, void* stream) {
  const Planes& p = *static_cast<const Planes*>(planes);
  if (n_in < 1 || n_in > kMaxPlanes || chunk < 4 || (chunk & 3) != 0 ||
      n < chunk || n % chunk != 0 || chain < 0 || out == nullptr ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      !planes_ok(p, n_in, 1))
    return int(cudaErrorInvalidValue);
  for (int k = 0; k < n_in; ++k)
    if (p.kind[k] != kSelf) return int(cudaErrorInvalidValue);
  const int64_t bytes = 2 * int64_t(n_in) * chunk * int64_t(sizeof(float));
  if (bytes > kMaxSmem) return int(cudaErrorInvalidValue);
  static int granted = 0;
  cudaError_t rc =
      allow_smem(probe_stream_pipelined_kernel, int(bytes), granted);
  if (rc != cudaSuccess) return int(rc);
  static int64_t occupancy_bytes = -1;  // per_sm was found for this size
  static int per_sm = 0;
  if (bytes != occupancy_bytes) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, probe_stream_pipelined_kernel, kThreads, int(bytes));
    if (rc != cudaSuccess) return int(rc);
    occupancy_bytes = bytes;
  }
  const int64_t n_chunks = n / chunk;
  int64_t blocks = int64_t(sm_count()) * (per_sm > 0 ? per_sm : 1);
  if (blocks > n_chunks) blocks = n_chunks;
  probe_stream_pipelined_kernel<<<int(blocks), kThreads, int(bytes),
                                  (cudaStream_t)stream>>>(
      p, static_cast<float*>(out), n_in, n_chunks, chunk, chain, mul);
  return int(cudaGetLastError());
}

int probe_flipsum(const void* x, void* out, int variant, int64_t n, int lo,
                  int hi, int tile_bits, void* stream) {
  if (n < 1 || (n & (n - 1)) != 0 || lo < 0 || hi < lo ||
      hi - lo > kMaxFlipBits || (int64_t(1) << hi) > n || variant < kGather ||
      variant > kMma)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = (cudaStream_t)stream;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (variant == kGather) {
    probe_flipsum_kernel<kGather><<<grid_for(n, kThreads), kThreads, 0, st>>>(
        xf, of, n, lo, hi, tile_bits);
    return int(cudaGetLastError());
  }
  if (tile_bits < 8 || (int64_t(1) << tile_bits) > n ||
      (variant == kMma && (tile_bits < 11 || lo != 0 || hi < 7)) ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)  // bulk copies' rule
    return int(cudaErrorInvalidValue);
  // the tile sizes the variants accepted with a whole tile (the MMA
  // variant's and its lane sums) in shared memory
  const int64_t bytes =
      (variant == kMma ? 2 : 1) * (int64_t(4) << tile_bits);
  if (bytes > kMaxSmem) return int(cudaErrorInvalidValue);
  if (variant == kTile) {
    int log_n = 0;
    while ((int64_t(1) << log_n) < n) ++log_n;
    int stage_bits = tile_bits > kFlipStageMinBits ? tile_bits
                                                   : kFlipStageMinBits;
    if (stage_bits > log_n) stage_bits = log_n;
    return hi > stage_bits
               ? launch_flipsum_tile<true>(xf, of, n, lo, hi, stage_bits, st)
               : launch_flipsum_tile<false>(xf, of, n, lo, hi, stage_bits,
                                            st);
  }
  if (variant == kMma)
    return hi > kFlipMmaTileBits ? launch_flipsum_mma<true>(xf, of, n, hi, st)
                                 : launch_flipsum_mma<false>(xf, of, n, hi, st);
  static int granted = 0;
  const cudaError_t rc =
      allow_smem(probe_flipsum_kernel<kShfl>, int(bytes), granted);
  if (rc != cudaSuccess) return int(rc);
  probe_flipsum_kernel<kShfl><<<int(n >> tile_bits), kThreads, int(bytes),
                                st>>>(xf, of, n, lo, hi, tile_bits);
  return int(cudaGetLastError());
}

int probe_tile_mma_f32(const void* x, const void* m, void* out, int mode,
                       int64_t rows, void* stream) {
  if (rows < 16 || rows % 16 != 0 || mode < 0 || mode > 1 ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)  // bulk copies' rule
    return int(cudaErrorInvalidValue);
  cudaStream_t st = (cudaStream_t)stream;
  return mode == 1 ? launch_tile_mma_tf32<true>(x, m, out, rows, st)
                   : launch_tile_mma_tf32<false>(x, m, out, rows, st);
}

int probe_tile_mma_f64(const void* x, const void* m, void* out, int64_t rows,
                       void* stream) {
  if (rows < 8 || rows % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)  // bulk copies' rule
    return int(cudaErrorInvalidValue);
  static int granted = 0;
  const cudaError_t rc =
      allow_smem(probe_tile_mma_f64_kernel, kF64Smem, granted);
  if (rc != cudaSuccess) return int(rc);
  const int64_t tiles = (rows + kF64TileRows - 1) / kF64TileRows;
  const int blocks = int(tiles < sm_count() ? tiles : sm_count());
  probe_tile_mma_f64_kernel<<<blocks, kPipeThreads, kF64Smem,
                              (cudaStream_t)stream>>>(
      (const double*)x, (const double*)m, (double*)out, rows);
  return int(cudaGetLastError());
}

// A refused size returns the error of cudaFuncSetAttribute and launches
// nothing.
int probe_smem(const void* x, void* out, int n, int bytes, void* stream) {
  if (n < 1 || bytes < 4 * n) return int(cudaErrorInvalidValue);
  static int granted = 0;
  const cudaError_t rc = allow_smem(probe_smem_kernel, bytes, granted);
  if (rc != cudaSuccess) {
    cudaGetLastError();  // clear it: the refusal is the probe's answer
    return int(rc);
  }
  probe_smem_kernel<<<1, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n, bytes);
  return int(cudaGetLastError());
}

int probe_flip_order_f64(const void* v0, void* out, const void* v1, void* phi,
                         const void* dmb, const void* G, const void* w,
                         int body, int nb, int L, int64_t n, int tile_bits,
                         int bits, double s2, double ak, void* stream) {
  if (L < 1 || L > kMaxBits || n != (int64_t(1) << L) || bits < 0 ||
      bits > L || tile_bits < 0 || tile_bits > L ||
      (int64_t(1) << tile_bits) * int64_t(sizeof(double2)) > kMaxSmem)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = (cudaStream_t)stream;
  switch (body) {
    case kFull:
      return launch_order_nb<kFull>(nb, v0, out, v1, phi, dmb, G, w,
                                    tile_bits, bits, n, s2, ak, st);
    case kCopy:
      return launch_order_nb<kCopy>(nb, v0, out, v1, phi, dmb, G, w,
                                    tile_bits, bits, n, s2, ak, st);
    case kNoFlips:
      return launch_order_nb<kNoFlips>(nb, v0, out, v1, phi, dmb, G, w,
                                       tile_bits, bits, n, s2, ak, st);
  }
  return int(cudaErrorInvalidValue);
}

int probe_fma_residual_f32(const void* a, const void* b, void* p, void* r,
                           int variant, int64_t n, void* stream) {
  return launch_fma<float>(a, b, p, r, variant, n, (cudaStream_t)stream);
}

int probe_fma_residual_f64(const void* a, const void* b, void* p, void* r,
                           int variant, int64_t n, void* stream) {
  return launch_fma<double>(a, b, p, r, variant, n, (cudaStream_t)stream);
}

int probe_extract(const void* x, void* q, void* r, int n, void* stream) {
  if (n < 1) return int(cudaErrorInvalidValue);
  probe_extract_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)q, (float*)r, n);
  return int(cudaGetLastError());
}

int probe_xor_permute(const void* x, void* out, int variant, int64_t n,
                      int bit, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0) {
    if (bit < 0 || bit >= 5 || n < 32 || n % 32 != 0)
      return int(cudaErrorInvalidValue);
    probe_xor_permute_kernel<0><<<grid_for(n, kThreads), kThreads, 0, st>>>(
        (const float*)x, (float*)out, n, bit);
  } else if (variant == 1) {
    if (bit < 0 || (1 << bit) >= kPermTile || n < kPermTile ||
        n % kPermTile != 0)
      return int(cudaErrorInvalidValue);
    probe_xor_permute_kernel<1><<<int(n / kPermTile), kThreads, 0, st>>>(
        (const float*)x, (float*)out, n, bit);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
