"""Time the tile-product kernels of ``csrc/probes.cu`` against variants
of themselves on one NVIDIA GPU.

    python3 tools/tile_mma_variants.py [--reps N] [--repeat N]

Each variant is a copy of ``probes.cu`` with one change made by text
substitution, built with the package's ``nvcc`` flags into
``quantumpropagators_torch/_build/tile_mma_variants/``:

- ``as built``;
- ``m8n8k4``: the FP64 kernel on Ampere's ``mma.sync`` shape, four
  m8n8k4 steps for each m16n8k16;
- ``no MMA``: the tensor-core instructions taken out (the ring, the
  fragment loads and splits and the stores alone);
- ``no stores``: the results never written to device memory;
- ``register stores``: 3xTF32's other store path.  As built the group
  writes its tile back into the stage it read (no room for output
  buffers beside M's two parts), sends it out with one TMA bulk store,
  and frees the stage once that store has read it; here each thread
  stores its results from registers and the stage is freed as soon as
  the second half of the fragments is loaded.

Each runs the TF32 and 3xTF32 products on a (2^19, 128) f32 plane and
the FP64 product on a (2^18, 128) f64 plane, as ``chip_smoke.py`` phase
16b does (``m8n8k4`` only the FP64 one, ``register stores`` only 3xTF32);
times are ``profiling.time_ms`` (a replayed CUDA graph of ``reps``
launches), taken twice in turn (every variant, then every variant
again).  A variant that computes the product is held against the plain
version first (2e-6, 2e-6 and 1e-14 of the largest value), and ``as
built`` is launched ``repeat`` more times on the same inputs, each
output equal bit for bit to the first (a race in the ring would show).
``Tensor.copy_`` of the plane and ``torch.matmul`` are timed beside them
as yardsticks.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]

F64_MMA = "          mma_f64_k16(acc[mi][nt], a, b);"
# the same products as m8n8k4 steps: a (g, t), b (t, g), d (g, 2t), (g, 2t+1)
F64_M8N8K4 = r"""#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              asm volatile(
                  "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
                  "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
                  : "+d"(acc[mi][nt][2 * h]), "+d"(acc[mi][nt][2 * h + 1])
                  : "d"(av[2 * mi + h][j]), "d"(b[j]));"""

TF32_MMA = "        wgmma_tf32(d, a[ks], tf32_b_desc(bs, ks));\n"
SPLIT_MMA = """          wgmma_tf32(d, al[ks], tf32_b_desc(bs, 8 * h + ks));
          wgmma_tf32(d, a[ks], tf32_b_desc(bl, 8 * h + ks));
          wgmma_tf32(d, a[ks], tf32_b_desc(bs, 8 * h + ks));
"""
# 3xTF32 as built frees its stage once the tile has gone out through it;
# the variant frees it as soon as the second half of the fragments is
# loaded and stores each thread's results from registers
SPLIT_HALF = "        tile_fragments<true, 8>(xs + 64 * h, a, al);\n"
SPLIT_HALF_FREE = SPLIT_HALF + r"""        if (h == 1) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);
        }
"""
STAGE_BUF = r"""    float* buf =
        Split ? reinterpret_cast<float*>(ring + s * kTf32StageBytes) : obuf;
"""
REGISTER_STORE = r"""    if constexpr (Split) {
      if (r0 + 16 * w < rows) {
        float* o = out + ((r0 + 16 * w + g) << 7) + 2 * t;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          *reinterpret_cast<float2*>(o + 8 * j) =
              make_float2(d[4 * j], d[4 * j + 1]);
          *reinterpret_cast<float2*>(o + 1024 + 8 * j) =
              make_float2(d[4 * j + 2], d[4 * j + 3]);
        }
      }
      continue;
    }
    float* buf = obuf;
"""

# name: ([(old, new) substitutions], computes the product, products run)
VARIANTS = {
    "as built": ([], True, ("tf32", "3xtf32", "f64")),
    "m8n8k4": ([(F64_MMA, F64_M8N8K4)], True, ("f64",)),
    "no MMA": ([
        (TF32_MMA, "        ;\n"),
        (SPLIT_MMA, ""),
        (F64_MMA, "          acc[mi][nt][0] += a[0] * b[0];"),
    ], False, ("tf32", "3xtf32", "f64")),
    "no stores": ([
        ("      bulk_store(out + (r0 << 7), buf, uint32_t(n * 512));", ""),
        ("        if (r < rows) {  // R is a multiple of 8",
         "        if (r < 0) {  // R is a multiple of 8"),
    ], False, ("tf32", "3xtf32", "f64")),
    "register stores": ([
        (SPLIT_HALF, SPLIT_HALF_FREE),
        (STAGE_BUF, REGISTER_STORE),
    ], True, ("3xtf32",)),
}
TOL = {"tf32": 2e-6, "3xtf32": 2e-6, "f64": 1e-14}


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
    for i, (name, (subs, _, _)) in enumerate(VARIANTS.items()):
        text = src
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
        for fn in ("probe_tile_mma_f32", "probe_tile_mma_f64"):
            getattr(lib, fn).argtypes = _cuda._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
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
    libs = build_variants(HERE / "quantumpropagators_torch" / "_build"
                          / "tile_mma_variants")
    tag = f"[{card()}]"
    n = 1 << 26
    xs = planes(n, 2, dev, seed=0)
    x32, M32 = xs[0].view(-1, 128), xs[1][:128 * 128].view(128, 128)
    x64, M64 = x32[: n // 256].double(), M32.double()
    o32, o64 = torch.empty_like(x32), torch.empty_like(x64)
    want = {"tf32": probes.probe_tile_mma_plain(x32, M32, "tf32"),
            "3xtf32": probes.probe_tile_mma_plain(x32, M32, "3xtf32"),
            "f64": probes.probe_tile_mma_plain(x64, M64, "f64")}
    outs = {"tf32": o32, "3xtf32": torch.empty_like(x32), "f64": o64}

    def launch(lib, what):
        # the current stream: a side stream while time_ms records a graph
        stream = torch.cuda.current_stream(dev).cuda_stream
        if what != "f64":
            rc = lib.probe_tile_mma_f32(x32.data_ptr(), M32.data_ptr(),
                                        outs[what].data_ptr(),
                                        probes.MMA_MODES[what], x32.shape[0],
                                        stream)
        else:
            rc = lib.probe_tile_mma_f64(x64.data_ptr(), M64.data_ptr(),
                                        o64.data_ptr(), x64.shape[0], stream)
        if rc:
            raise RuntimeError(f"{what}: launch failed ({rc})")

    for name, lib in libs.items():
        _, computes, kinds = VARIANTS[name]
        for what in kinds if computes else ():
            launch(lib, what)
            rel = TOL[what]
            ref = want[what].double()
            err = float((outs[what].double() - ref).abs().max())
            if err > rel * float(ref.abs().max()):
                raise AssertionError(f"{name} {what}: max|d| {err:.3e}")
            print(f"variant {name} {what}: held, max|d| {err:.3e}",
                  flush=True)
    # a race in the ring shows as a launch that differs from the first
    lib = libs["as built"]
    for what, out in outs.items():
        launch(lib, what)
        first = out.clone()
        for _ in range(args.repeat):
            out.zero_()
            launch(lib, what)
            if not torch.equal(out, first):
                raise AssertionError(f"as built {what}: a repeated launch "
                                     f"differs from the first")
        print(f"variant as built {what}: {args.repeat} more launches equal "
              f"the first bit for bit", flush=True)
    times = {}
    for _ in range(2):
        for name, lib in libs.items():
            for what in VARIANTS[name][2]:
                times.setdefault((name, what), []).append(
                    time_ms(lambda: launch(lib, what), args.reps))
    for (name, what), ms in times.items():
        print(f"variant {name} {what}: {ms[0]:.4f} / {ms[1]:.4f} ms {tag}",
              flush=True)

    def matmul(a, b, o, tf32):
        def run():
            saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                torch.matmul(a, b, out=o)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = saved
        return run

    for what, fn in (("copy_ of the f32 plane", lambda: o32.copy_(x32)),
                     ("torch.matmul TF32", matmul(x32, M32, o32, True)),
                     ("torch.matmul f32", matmul(x32, M32, o32, False)),
                     ("torch.matmul f64", matmul(x64, M64, o64, False))):
        print(f"yardstick {what}: {time_ms(fn, args.reps):.4f} / "
              f"{time_ms(fn, args.reps):.4f} ms {tag}", flush=True)
    return times


if __name__ == "__main__":
    main()
