"""Time ``probe_stream`` of ``csrc/probes.cu`` against variants of itself
on one NVIDIA GPU.

    python3 tools/stream_variants.py [--reps N]

Each variant is a copy of ``probes.cu`` with one change made by text
substitution, built with the package's ``nvcc`` flags into
``quantumpropagators_torch/_build/stream_variants/``.  What each changes
against the kernel as built (one block a chunk of 256 float4s, one
float4 of each plane a thread; registers sized to the body's planes;
compile-time map kinds; loads and stores in the default cache policy):

- ``as built``;
- ``16 blocks an SM``: the grid capped at 16 blocks an SM, each block
  walking chunks a grid apart (the launch of the kernel before its
  redesign, more blocks than stay resident: two waves);
- ``persistent``: one wave of as many blocks as stay resident, each
  walking chunks a grid apart;
- ``runtime maps``: every plane's map kind read at run time, also in
  all-self bodies;
- ``4-plane registers``: the bodies of 1 to 3 planes in registers for 4
  planes, as before the redesign;
- ``evict-first``: ``ld.global.cs`` / ``st.global.cs`` in place of the
  default cache policy;
- ``L1::no_allocate``: loads by ``ld.global.nc.L1::no_allocate``;
- ``U = 4``, ``U = 8``: float4s a thread of the small bodies (chunks of
  256 x U float4s);
- ``TMA bulk copy`` (copy only, an added kernel): the plane through
  shared memory by TMA bulk copies, global to shared and shared to
  global, six 32 KB stages a block, one block an SM, no thread touching
  the data; it reads what the bulk copies of the tile products' ring
  cost alone.

Each runs copy, add, triad and the 64-link FMA chain on planes of 2^26
elements and the 16-plane sum (``seq`` and ``xor`` maps, tiles of 1024
rows) on planes of 2^22, as ``chip_smoke.py`` phase 16b and the
``scatter`` probe do; times are ``profiling.time_ms`` (a replayed CUDA
graph of ``reps`` launches), taken twice in turn (every variant, then
every variant again).  Every variant is first held against the plain
version on the timed inputs (bit for bit; triad 2e-6 and the chain 1e-5
of the largest value).  ``Tensor.copy_``, ``torch.add`` and
``torch.addcmul`` are timed beside them as yardsticks, into the variants'
one output buffer; ``clone``, ``torch.addcmul`` and the package's
``probes.probe_stream`` also into a new output each call, as phase 16b
calls them.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]

SMALL = ("launch_stream<kTriad, 3, 1>", "launch_stream<kChain, 2, 1>",
         "launch_stream<kSum, 1, 1>", "launch_stream<kSum, 2, 1>",
         "launch_stream<kSum, 4, 1>")
GRID = "  const int blocks = int(n_chunks);\n  probe_stream_kernel"
LOAD = "  return *reinterpret_cast<const float4*>(src);"
STORE = "  *reinterpret_cast<float4*>(dst) = v;"


def _unroll(u):
    return [(old, old[:-2] + f"{u}>") for old in SMALL]


# a copy through shared memory by TMA bulk copies, appended to the source
BULK_COPY = r"""
namespace {
constexpr int kBulkStages = 6;
constexpr int kBulkStageBytes = 32768;
constexpr int kBulkLag = 2;  // stores in flight before a stage is freed
constexpr int kBulkSmem = kBulkStages * kBulkStageBytes + 2 * kBulkStages * 8;

// Thread 0 loads tile i of the block into stage i % kBulkStages once the
// stage is free; thread 32 stores each loaded stage back out and frees a
// stage once the store kBulkLag groups back has read it.
__global__ void __launch_bounds__(64, 1)
    probe_bulk_copy_kernel(const unsigned char* x, unsigned char* out,
                           int64_t n_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kBulkStages * kBulkStageBytes);
  uint64_t* empty = full + kBulkStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBulkStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int64_t n_tiles = (n_bytes + kBulkStageBytes - 1) / kBulkStageBytes;
  int64_t i = 0;
  if (threadIdx.x == 0) {
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const int s = int(i % kBulkStages);
      mbar_wait(&empty[s], uint32_t((i / kBulkStages) & 1) ^ 1u);
      const int64_t b0 = tile * kBulkStageBytes;
      const uint32_t n = uint32_t(n_bytes - b0 < kBulkStageBytes
                                      ? n_bytes - b0 : kBulkStageBytes);
      mbar_expect_tx(&full[s], n);
      bulk_load(smem + s * kBulkStageBytes, x + b0, n, &full[s]);
    }
  } else if (threadIdx.x == 32) {
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const int s = int(i % kBulkStages);
      mbar_wait(&full[s], uint32_t((i / kBulkStages) & 1));
      const int64_t b0 = tile * kBulkStageBytes;
      const uint32_t n = uint32_t(n_bytes - b0 < kBulkStageBytes
                                      ? n_bytes - b0 : kBulkStageBytes);
      bulk_store(out + b0, smem + s * kBulkStageBytes, n);
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kBulkLag)
                   : "memory");
      if (i >= kBulkLag) mbar_arrive(&empty[(i - kBulkLag) % kBulkStages]);
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}
}  // namespace

extern "C" int probe_bulk_copy(const void* x, void* out, int64_t n,
                               void* stream) {
  if (n < 4 || (n & 3) != 0 || (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return int(cudaErrorInvalidValue);
  static int granted = 0;
  const cudaError_t rc =
      allow_smem(probe_bulk_copy_kernel, kBulkSmem, granted);
  if (rc != cudaSuccess) return int(rc);
  probe_bulk_copy_kernel<<<sm_count(), 64, kBulkSmem, (cudaStream_t)stream>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
      4 * n);
  return int(cudaGetLastError());
}
"""

# name: [(old, new) substitutions]
VARIANTS = {
    "as built": [],
    "16 blocks an SM": [(GRID, GRID.replace(
        "int(n_chunks)",
        "int(n_chunks < 16 * sm_count() ? n_chunks : 16 * sm_count())"))],
    "persistent": [(GRID, GRID.replace("int(n_chunks);", """int(n_chunks);
  static int resident = 0;  // blocks an SM; one instantiation each
  if (resident == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, probe_stream_kernel<Op, MaxIn, U, Mapped, Half>, kThreads,
        0);
  const int64_t wave = int64_t(sm_count()) * (resident > 0 ? resident : 1);
  blocks = int(n_chunks < wave ? n_chunks : wave);""").replace(
        "const int blocks", "int blocks"))],
    "runtime maps": [("  if (Mapped && p.kind[k] != kSelf) {",
                      "  if (p.kind[k] != kSelf) {")],
    "4-plane registers": [(old, old.replace(", 1, 1>", ", 4, 1>").replace(
        ", 2, 1>", ", 4, 1>").replace(", 3, 1>", ", 4, 1>"))
        for old in SMALL if ", 4, 1>" not in old],
    "evict-first": [
        (LOAD, "  return __ldcs(reinterpret_cast<const float4*>(src));"),
        (STORE, "  __stcs(reinterpret_cast<float4*>(dst), v);")],
    "L1::no_allocate": [(LOAD, r"""  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(src));
  return v;""")],
    "U = 4": _unroll(4),
    "U = 8": _unroll(8),
    "TMA bulk copy": [],
}
# (body, op, planes, chain, tolerance relative to max|plain|, bytes moved a
# element of a plane)
BODIES = {
    "copy": ("sum", 1, 0, 0, 8),
    "add": ("sum", 2, 0, 0, 12),
    "triad": ("triad", 3, 0, 2e-6, 16),
    "fma64": ("chain", 2, 64, 1e-5, 12),
}
SCATTER = ("seq", "xor")


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def build_variants(out_dir):
    """One shared library a variant, built in parallel; returns
    ``{name: ctypes library}``."""
    sys.path.insert(0, str(HERE))
    from quantumpropagators_torch.ops import _cuda

    src = (HERE / "quantumpropagators_torch/csrc/probes.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src + (BULK_COPY if name == "TMA bulk copy" else "")
        for old, new in subs:
            if old not in text:
                raise ValueError(f"{name}: {old!r} not in the source")
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
        lib = ctypes.CDLL(str(out_dir / f"variant{i}.so"))
        lib.probe_stream.argtypes = _cuda._SIGNATURES["probe_stream"]
        lib.probe_stream.restype = ctypes.c_int
        if name == "TMA bulk copy":
            lib.probe_bulk_copy.argtypes = [ctypes.c_void_p] * 2 + [
                ctypes.c_int64, ctypes.c_void_p]
            lib.probe_bulk_copy.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    from quantumpropagators_torch.ops import probes
    from quantumpropagators_torch.profiling import cuda_device, planes, \
        scatter, time_ms

    dev = cuda_device()
    libs = build_variants(HERE / "quantumpropagators_torch" / "_build"
                          / "stream_variants")
    tag = f"[{card()}]"
    n = 1 << 26
    big = planes(n, 3, dev, seed=0)
    s16 = planes(1 << 22, scatter.N_IN, dev, seed=1, scale=1e-3)
    tile_bits = 17  # tiles of 1024 rows, as the scatter probe
    o1, o2 = torch.empty_like(big[0]), torch.empty_like(big[0])
    s1, s2 = torch.empty_like(s16[0]), torch.empty_like(s16[0])
    # case: (inputs, maps, op, chain, n_out, outputs, tolerance, bytes)
    cases = {}
    for body, (op, n_in, chain, rel, per) in BODIES.items():
        cases[body] = (big[:n_in], [("self", 0)] * n_in, op, chain, 1,
                       (o1,), rel, per * n)
    for mode in SCATTER:
        cases[f"16 planes {mode}"] = (
            s16, scatter.maps(mode, (1 << 22) >> tile_bits), "sum", 0, 2,
            (s1, s2), 0, 18 * 4 << 22)
    structs = {k: probes._planes(c[0], c[1]) for k, c in cases.items()}

    def launch(lib, case):
        xs, _, op, chain, n_out, outs, _, _ = cases[case]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if lib is libs["TMA bulk copy"] and case == "copy":
            rc = lib.probe_bulk_copy(xs[0].data_ptr(), outs[0].data_ptr(), n,
                                     stream)
        else:
            rc = lib.probe_stream(
                ctypes.addressof(structs[case]), outs[0].data_ptr(),
                outs[1].data_ptr() if n_out == 2 else None,
                probes.STREAM_OPS[op], len(xs), xs[0].numel(), tile_bits,
                chain, 1.0000001 if chain else 1.0, 1.0, stream)
        if rc:
            raise RuntimeError(f"{case}: launch failed ({rc})")

    def ran(name):
        return ("copy",) if name == "TMA bulk copy" else tuple(cases)

    for name, lib in libs.items():
        for case in ran(name):
            xs, maps, op, chain, n_out, outs, rel, _ = cases[case]
            launch(lib, case)
            want = probes.probe_stream_plain(
                xs, op, maps=maps, tile_bits=tile_bits, chain=chain,
                mul=1.0000001 if chain else 1.0, n_out=n_out)
            for got, ref in zip(outs, want):
                err = float((got.double() - ref.double()).abs().max())
                if not (torch.equal(got, ref) if rel == 0 else
                        err <= rel * float(ref.double().abs().max())):
                    raise AssertionError(f"{name} {case}: max|d| {err:.3e}")
        print(f"variant {name}: held against the plain version on "
              f"{', '.join(ran(name))}", flush=True)
    times = {}
    for _ in range(2):
        for name, lib in libs.items():
            for case in ran(name):
                times.setdefault((name, case), []).append(
                    time_ms(lambda: launch(lib, case), args.reps))
    for (name, case), ms in times.items():
        gbs = cases[case][7] / min(ms) / 1e6
        print(f"variant {name} {case}: {ms[0]:.4f} / {ms[1]:.4f} ms "
              f"({gbs:.0f} GB/s at the faster) {tag}", flush=True)
    x, y, z = big
    # into one output buffer, as the variants above write; and, as the
    # package's wrapper and chip_smoke.py phase 16b call them, into a new
    # output each call (from the timing graph's memory pool)
    for what, fn in (("copy_", lambda: o1.copy_(x)),
                     ("torch.add", lambda: torch.add(x, y, out=o1)),
                     ("torch.addcmul", lambda: torch.addcmul(x, y, z,
                                                             out=o1)),
                     ("clone, a new output", lambda: x.clone()),
                     ("torch.addcmul, a new output",
                      lambda: torch.addcmul(x, y, z)),
                     ("probes.probe_stream copy, a new output",
                      lambda: probes.probe_stream([x])),
                     ("probes.probe_stream triad, a new output",
                      lambda: probes.probe_stream([x, y, z], "triad"))):
        print(f"yardstick {what}: {time_ms(fn, args.reps):.4f} / "
              f"{time_ms(fn, args.reps):.4f} ms {tag}", flush=True)
    return times


if __name__ == "__main__":
    main()
