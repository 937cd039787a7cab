"""Time the flip-sum kernels of ``csrc/probes.cu`` (``probe_flipsum``
``tile``, ``shfl``, ``mma`` and ``gather``) against variants of
themselves on one NVIDIA GPU.

    python3 tools/flipsum_variants.py [--reps N] [--repeat N]

Each variant is a copy of ``probes.cu`` with one change made by text
substitution, built with the package's ``nvcc`` flags into
``quantumpropagators_torch/_build/flipsum_variants/``:

- ``as built``: tile and shfl one block a stage (2^12 elements), mma
  persistent blocks through a 4-stage ring, gather one block a chunk of
  256 float4s; ``tile`` as built is ``shfl`` with the partners of bits
  2-6 read from shared memory in place of shuffled;
- ``ring: chunks of 2, 2 stages`` and ``ring: chunks of 4, 3 stages``
  (tile): each block walks 2 or 4 consecutive stages through a ring, so
  that its next loads run under its sums and stores;
- ``persistent ring, 2 an SM x 7 stages`` (tile): two blocks an SM walk
  the stages ``b, b + grid, ...`` through 7 stages (the tile products'
  ring);
- ``run-time bit loop`` (tile): the in-stage bit loop ``lo .. mid`` at run
  time, not unrolled, in place of the unrolled loop over a fixed maximum
  with a mask;
- ``scalar`` (tile, shfl): one element a thread in place of a float4,
  every in-stage partner (bits 0 and 1 too) one 4-byte shared load; for
  shfl those of bits 0-4 (the lane bits of one element a thread) by one
  scalar shuffle each;
- ``no producer warp`` (tile): 256 threads, thread 0 issues the block's
  bulk copy;
- ``cp.async`` (tile): 256 threads, each copies its share of the tile with
  ``cp.async`` (the flip order's tiled pass loads its tile so);
- ``x in the product`` (mma): B = A01 + I, so that the product carries x
  and the epilogue does not read it from the stage;
- ``stage stores`` (mma): the tile written back into its stage and sent
  out by one TMA bulk store, the stage freed once that store has read it,
  in place of each thread's float4 stores;
- ``no MMA`` (mma): the ``wgmma`` instructions taken out (the ring, the
  fragment loads and the epilogue alone; the result lacks bits 0-6);
- ``scalar gather`` (gather): one element a thread in a grid-stride loop
  of at most 16 blocks an SM, every partner one 4-byte load (the kernel
  before its float4 redesign);
- ``gather: loads in flight first``: the bit loop at compile time over
  16 slots masked by ``lo`` and ``hi``, every load of a float4 issued
  before its first add, in place of the run-time loop that adds each load
  as it comes;
- ``gather: compile-time bit loop``: the same masked loop over 16 slots,
  each load added as it comes;
- ``gather: grid-stride, 16 blocks an SM``: the float4 kernel in a
  grid-stride loop of ``grid_for``'s size in place of one block a chunk;
- ``gather: plain loads``: ``ld.global`` in place of the read-only path
  (``ld.global.nc``, ``__ldg``).

Each times the 9-bit flip sum (bits 0-8) of a 2^26-element f32 plane at
``profiling/flips.py``'s tile sizes (tile, shfl and gather 12, mma 13), as
``chip_smoke.py`` phase 16b does, with ``profiling.time_ms`` (a replayed
CUDA graph of ``reps`` launches), twice in turn (every variant, then every
variant again).  A variant that computes the flip sum is held against the
plain version first (tile, shfl and gather bit for bit, mma 2e-6 of the
largest value), and ``as built`` is launched ``repeat`` more times on the
same plane, each output equal bit for bit to the first.
``Tensor.copy_`` of the plane is timed beside them.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
SOURCE = HERE / "quantumpropagators_torch/csrc/probes.cu"

TILE_LOOP_START = ("    for (int q = threadIdx.x; q < n4; "
                   "q += kFlipConsumers) {\n")
TILE_LOOP_END = "      st_stream(out + e, acc);\n    }\n"
SCALAR_LOOP = r"""    const float* sf = reinterpret_cast<const float*>(s4);
    for (int k = threadIdx.x; k < 4 * n4; k += kFlipConsumers) {
      const int64_t e = base + k;
      float far[Above ? kMaxFlipBits : 1];
      if constexpr (Above) {
#pragma unroll
        for (int c = 0; c < kMaxFlipBits; ++c)
          if (g0 + c < hi) far[c] = x[e ^ (int64_t(1) << (g0 + c))];
      }
      const float v = sf[k];
      float acc = v;
#pragma unroll
      for (int j = 0; j < kFlipStageMaxBits; ++j)
        if ((in_stage >> j) & 1u)
          acc += Shfl && j < 5 ? __shfl_xor_sync(0xffffffffu, v, 1 << j)
                               : sf[k ^ (1 << j)];
      if constexpr (Above) {
#pragma unroll
        for (int c = 0; c < kMaxFlipBits; ++c)
          if (g0 + c < hi) acc += far[c];
      }
      out[e] = acc;
    }
"""
BIT_LOOP = ("#pragma unroll\n"
            "      for (int j = 0; j < kFlipStageMaxBits; ++j)\n")
RUNTIME_BIT_LOOP = "#pragma unroll 1\n      for (int j = lo; j < mid; ++j)\n"
MMA_PASSES = """        wgmma_tf32(d, al[ks], tf32_b_desc(bs, 8 * h + ks));
        wgmma_tf32(d, a[ks], tf32_b_desc(bs, 8 * h + ks));
"""
MMA_D = "          const float* dq = d + 8 * q + 2 * hr;\n"
MMA_STAGE = ("    const float* st =\n        reinterpret_cast<const float*>("
             "ring + s * kTf32StageBytes);\n")
MMA_TAIL = """          st_stream(out + e, acc);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
"""
# the tile back into its stage once the group has read its partners, out
# by one TMA bulk store, the stage freed once that store has read it
STAGE_STORE = r"""          dq[0] = acc.x;
          dq[1] = acc.y;
          dq[4] = acc.z;
          dq[5] = acc.w;
        }
      }
    }
    group_sync(group);
    if (16 * w < valid) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float* dq = d + 8 * q + 2 * hr;
          *reinterpret_cast<float4*>(st + ((r + 8 * hr) << 7) + 16 * q +
                                     4 * t) =
              make_float4(dq[0], dq[1], dq[4], dq[5]);
        }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    group_sync(group);
    const bool leader = (threadIdx.x & 127) == 0;
    if (leader) {
      bulk_store(out + (r0 << 7), st, uint32_t(valid * 512));
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (leader && tile + 2 * int64_t(gridDim.x) >= n_tiles)  // its last
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
"""
FLIP_ONLY = "  return (d != 0 && (d & (d - 1)) == 0) ? kOneTf32 : 0u;\n"
SELF_OR_FLIP = "  return (d & (d - 1)) == 0 ? kOneTf32 : 0u;\n"
X_FROM_STAGE = """          const float4 v =
              *reinterpret_cast<const float4*>(st + (rr << 7) + col);
          const float* dq = d + 8 * q + 2 * hr;
          float4 acc = make_float4(v.x + dq[0], v.y + dq[1], v.z + dq[4],
                                   v.w + dq[5]);
"""
X_IN_PRODUCT = """          const float* dq = d + 8 * q + 2 * hr;
          float4 acc = make_float4(dq[0], dq[1], dq[4], dq[5]);
"""
CHUNK = ("constexpr int kFlipTilesPerBlock = 1;\n"
         "constexpr int kFlipStages = 1;\n")
STRIDE = ("  const int64_t first = int64_t(blockIdx.x) * per_block;\n"
          "  const int64_t step = 1;\n")
GRID = ("  const int64_t per_block = kFlipTilesPerBlock;\n",
        "  const int64_t tiles = n >> stage_bits;\n"
        "  const int blocks = int((tiles + per_block - 1) / per_block);\n")
PRODUCER = ("  if (count > per_block) count = per_block;\n"
            "  if (warp == kProducerWarp) {\n    if (lane == 0)\n",
            "    return;\n  }\n  const int mid = hi < stage_bits")
LAUNCH = ("      <<<blocks, kPipeThreads, bytes, st>>>(x, out, n, lo, hi, "
          "stage_bits,\n")
FULL_WAIT = "    mbar_wait(&full[s], uint32_t((i / stages) & 1));\n"
CP_ASYNC_LOAD = r"""    {
      const float* src = x + ((first + i * step) << stage_bits);
      float* dst = reinterpret_cast<float*>(smem + s * stage_bytes);
      for (int q = threadIdx.x; q < (stage_bytes >> 4); q += kFlipConsumers)
        cp_async16(dst + 4 * q, src + 4 * q);
      cp_async_wait_all();
      __syncthreads();
    }
"""

GATHER_Q = ("  const int64_t q = int64_t(blockIdx.x) * kThreads + threadIdx.x;\n"
            "  if (q >= n4) return;\n")
GATHER_END = "  out[q] = acc;\n}\n"
GATHER_GRID = "  const int blocks = int((n4 + kThreads - 1) / kThreads);\n"
GATHER_LOOP = ("#pragma unroll 1\n"
               "  for (int j = lo > 2 ? lo : 2; j < hi; ++j)\n"
               "    acc = add4(acc, ld_nc(x + (q ^ (int64_t(1) << (j - 2)))));"
               "\n")
GATHER_MASK = r"""  const int g = lo > 2 ? lo : 2;  // the first bit read from memory
  const uint32_t far = hi > g ? (1u << (hi - g)) - 1u : 0u;  // bits g + c
"""
# every load of a float4 in flight before its first add
GATHER_IN_FLIGHT = GATHER_MASK + r"""  float4 y[kMaxFlipBits];
#pragma unroll
  for (int c = 0; c < kMaxFlipBits; ++c)
    if ((far >> c) & 1u) y[c] = ld_nc(x + (q ^ (int64_t(1) << (g + c - 2))));
#pragma unroll
  for (int c = 0; c < kMaxFlipBits; ++c)
    if ((far >> c) & 1u) acc = add4(acc, y[c]);
"""
# the same loop, each load added as it comes
GATHER_UNROLLED = GATHER_MASK + r"""#pragma unroll
  for (int c = 0; c < kMaxFlipBits; ++c)
    if ((far >> c) & 1u)
      acc = add4(acc, ld_nc(x + (q ^ (int64_t(1) << (g + c - 2)))));
"""
# the gather kernel before its float4 redesign, on the float4 kernel's
# arguments
GATHER_SCALAR = r"""  const float* xs = reinterpret_cast<const float*>(x);
  float* os = reinterpret_cast<float*>(out);
  const int64_t n = n4 << 2;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float y[kMaxFlipBits];
#pragma unroll
    for (int c = 0; c < kMaxFlipBits; ++c)
      if (lo + c < hi) y[c] = xs[i ^ (int64_t(1) << (lo + c))];
    float acc = xs[i];
#pragma unroll
    for (int c = 0; c < kMaxFlipBits; ++c)
      if (lo + c < hi) acc += y[c];
    os[i] = acc;
  }
}
"""
LD_NC = "{ return __ldg(p); }"
LD_PLAIN = r"""{
  float4 v;
  asm("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}"""


def _block(src, start, end):
    """The text of ``src`` from ``start`` through ``end``."""
    a = src.index(start)
    return src[a:src.index(end, a) + len(end)]


def chunk(per_block, stages):
    return [(CHUNK, f"constexpr int kFlipTilesPerBlock = {per_block};\n"
                    f"constexpr int kFlipStages = {stages};\n")]


def persistent_strided(per_sm, stages):
    """One block a slot of the card, ``per_sm`` an SM, walking the stages
    ``b, b + grid, ...``."""
    return chunk(1, stages) + [
        (STRIDE, "  const int64_t first = blockIdx.x;\n"
                 "  const int64_t step = gridDim.x;\n"),
        (GRID[0], "  const int64_t per_block = int64_t(1) << 40;\n"),
        (GRID[1], GRID[1].splitlines(True)[0]
         + f"  const int blocks = sm_count() * {per_sm};\n")]


def no_producer(src, cp_async):
    """256 threads, no producer warp: thread 0 issues the one bulk copy
    (the launch's one stage a block), or every thread its cp.async
    share."""
    producer = _block(src, *PRODUCER)
    subs = [(LAUNCH, LAUNCH.replace("kPipeThreads", "kFlipConsumers"))]
    if cp_async:
        return subs + [(producer, PRODUCER[0].splitlines(True)[0]
                        + "  const int mid = hi < stage_bits"),
                       (FULL_WAIT, CP_ASYNC_LOAD)]
    return subs + [(producer, producer.replace(
        PRODUCER[0], PRODUCER[0].splitlines(True)[0]
        + "  if (threadIdx.x == 0) {\n    if (true)\n").replace(
        PRODUCER[1], "  }\n  const int mid = hi < stage_bits"))]


def substitutions(src):
    """name: ([(old, new) substitutions], computes the flip sum, variants
    run)."""
    return {
        "as built": ([], True, ("tile", "shfl", "mma", "gather")),
        "ring: chunks of 2, 2 stages": (chunk(2, 2), True, ("tile",)),
        "ring: chunks of 4, 3 stages": (chunk(4, 3), True, ("tile",)),
        "persistent ring, 2 an SM x 7 stages": (persistent_strided(2, 7),
                                                True, ("tile",)),
        "run-time bit loop": ([(BIT_LOOP, RUNTIME_BIT_LOOP)], True,
                              ("tile",)),
        "scalar": ([(_block(src, TILE_LOOP_START, TILE_LOOP_END),
                     SCALAR_LOOP)], True, ("tile", "shfl")),
        "no producer warp": (no_producer(src, False), True, ("tile",)),
        "cp.async": (no_producer(src, True), True, ("tile",)),
        "x in the product": ([(FLIP_ONLY, SELF_OR_FLIP),
                              (X_FROM_STAGE, X_IN_PRODUCT)], True,
                             ("mma",)),
        "stage stores": ([(MMA_STAGE, "    float* st = reinterpret_cast<"
                           "float*>(ring + s * kTf32StageBytes);\n"),
                          (MMA_D, MMA_D.replace("const ", "")),
                          (MMA_TAIL, STAGE_STORE)], True, ("mma",)),
        "no MMA": ([(MMA_PASSES, "")], False, ("mma",)),
        "scalar gather": ([(_block(src, GATHER_Q, GATHER_END), GATHER_SCALAR),
                           (GATHER_GRID, "  const int blocks = grid_for(n, "
                                         "kThreads);\n")], True,
                          ("gather",)),
        "gather: loads in flight first": ([(GATHER_LOOP, GATHER_IN_FLIGHT)],
                                           True, ("gather",)),
        "gather: compile-time bit loop": ([(GATHER_LOOP, GATHER_UNROLLED)],
                                          True, ("gather",)),
        "gather: grid-stride, 16 blocks an SM": (
            [(GATHER_Q, "  for (int64_t q = int64_t(blockIdx.x) * kThreads "
                        "+ threadIdx.x; q < n4;\n"
                        "       q += int64_t(gridDim.x) * kThreads) {\n"),
             (GATHER_END, "  out[q] = acc;\n  }\n}\n"),
             (GATHER_GRID, "  const int blocks = grid_for(n4, kThreads);\n")],
            True, ("gather",)),
        "gather: plain loads": ([(LD_NC, LD_PLAIN)], True, ("gather",)),
    }


TILE_BITS = {"tile": 12, "shfl": 12, "mma": 13, "gather": 12}  # flips.py's
TOL = {"tile": 0, "shfl": 0, "mma": 2e-6, "gather": 0}
BITS = (0, 9)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def build_variants(variants, src, out_dir):
    """One shared library a variant, built in parallel; returns
    ``{name: ctypes library}``."""
    from quantumpropagators_torch.ops import _cuda

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (subs, _, _)) in enumerate(variants.items()):
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise ValueError(f"{name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
             str(out_dir / f"variant{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        regs, kernel = [], ""
        for ln in err.splitlines():  # the ring kernels' registers and spills
            if "Compiling entry function" in ln:
                kernel = ln
            elif "flipsum_" in kernel:
                if "registers" in ln or "spill" in ln:
                    regs.append(ln.split(":", 1)[-1].strip())
        print(f"variant {name}: built; ptxas {regs}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"variant{i}.so"))
        lib.probe_flipsum.argtypes = _cuda._SIGNATURES["probe_flipsum"]
        lib.probe_flipsum.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--repeat", type=int, default=200)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    from quantumpropagators_torch.ops import probes
    from quantumpropagators_torch.profiling import cuda_device, planes, \
        time_ms

    dev = cuda_device()
    src = SOURCE.read_text()
    variants = substitutions(src)
    libs = build_variants(variants, src, HERE / "quantumpropagators_torch"
                          / "_build" / "flipsum_variants")
    tag = f"[{card()}]"
    n = 1 << 26
    (x,) = planes(n, 1, dev, seed=0)
    out = torch.empty_like(x)
    lo, hi = BITS
    want = {v: probes.probe_flipsum_plain(x, lo, hi, v, tb)
            for v, tb in TILE_BITS.items()}

    def launch(lib, variant):
        # the current stream: a side stream while time_ms records a graph
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.probe_flipsum(x.data_ptr(), out.data_ptr(),
                               probes.FLIP_VARIANTS[variant], n, lo, hi,
                               TILE_BITS[variant], stream)
        if rc:
            raise RuntimeError(f"{variant}: launch failed ({rc})")

    for name, lib in libs.items():
        _, computes, kinds = variants[name]
        for variant in kinds if computes else ():
            out.fill_(float("nan"))
            launch(lib, variant)
            ref = want[variant].double()
            err = float((out.double() - ref).abs().max())
            if not err <= TOL[variant] * float(ref.abs().max()):
                raise AssertionError(f"{name} {variant}: max|d| {err:.3e}")
            print(f"variant {name} {variant}: held, max|d| {err:.3e}",
                  flush=True)
    # a race in the ring shows as a launch that differs from the first
    lib = libs["as built"]
    for variant in TILE_BITS:
        launch(lib, variant)
        first = out.clone()
        for _ in range(args.repeat):
            out.fill_(float("nan"))
            launch(lib, variant)
            if not torch.equal(out, first):
                raise AssertionError(f"as built {variant}: a repeated launch "
                                     f"differs from the first")
        print(f"variant as built {variant}: {args.repeat} more launches "
              f"equal the first bit for bit", flush=True)
    times = {}
    for _ in range(2):
        for name, lib in libs.items():
            for variant in variants[name][2]:
                times.setdefault((name, variant), []).append(
                    time_ms(lambda: launch(lib, variant), args.reps))
        times.setdefault(("copy_ of the plane", ""), []).append(
            time_ms(lambda: out.copy_(x), args.reps))
    for (name, variant), ms in times.items():
        print(f"variant {name} {variant}: {ms[0]:.4f} / {ms[1]:.4f} ms "
              f"{tag}", flush=True)
    return times


if __name__ == "__main__":
    main()
