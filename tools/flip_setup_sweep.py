"""Sweep the flip setup's two passes on one NVIDIA GPU, and time the
TFIM main path of a given checkout.

    python3 tools/flip_setup_sweep.py sweep
    python3 tools/flip_setup_sweep.py variants
    python3 tools/flip_setup_sweep.py main [ROOT]

``sweep`` times, at L = 24 in both types (CUDA events, 20 launches after
2 warm-ups): the tiled setup pass alone against the number of bits it
reads from L2 (``bits − tile_bits``), the same for the iteration pass,
the setup pass against its tile size, the high pass against h, the whole
setup (high pass + tiled pass) over h and tile size, and a PyTorch copy
of the state as a yardstick.  ``variants`` builds copies of the source
with one tuning value changed (block size, blocks per SM, load batch)
and times the setup over h and tile size and the iteration pass with
each.  ``main`` times 20 steps of the driven
L = 24 chain through ``propagate(fused=True)`` in both tiers with the
package found under ROOT (default: this checkout), three times each,
with the spectral envelope fixed to the one ``chip_smoke.py`` measures.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
L = 24
SEED = 20240611


def card():
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def sweep():
    sys.path.insert(0, str(HERE))
    from chip_smoke import kernel_inputs, time_ms
    from quantumpropagators_torch.ops import _cuda
    from quantumpropagators_torch.ops import cheby_flip as cf

    dev = torch.device("cuda", 0)
    _cuda.load()
    for ln in _cuda.build_info.get("ptxas", "").splitlines():
        if "Compiling entry" in ln or "registers" in ln:
            print("ptxas", ln.strip(), flush=True)
    tag = f"[{card()}]"
    for ctype in ("double", "float"):
        v0, v1, phi, dmb, G, s = kernel_inputs(L, ctype, dev, SEED)
        T, h0 = cf.flip_split(L, v0.dtype)
        n, esz = v0.numel(), v0.element_size()

        def first(w, tile, bits):
            return cf._launch_first(v0, dmb, G, s, 0.81, -0.45, w, L, tile,
                                    bits)

        def gbs(ms, vectors):
            return f"{vectors * n * esz / ms / 1e6:.0f} GB/s"

        buf = torch.empty_like(v0)
        ms = time_ms(lambda: buf.copy_(v0), 20)
        print(f"{ctype} copy v0 -> buf {ms:.4f} ms ({gbs(ms, 2)}) {tag}",
              flush=True)
        w_hi = cf._launch_high(v0, G, None, L, h0)
        for bits in range(T, L - h0 + 1):
            ms = time_ms(lambda: first(w_hi, T, bits), 20)
            print(f"{ctype} setup pass tile={T} bits={bits} "
                  f"(L2 bits {bits - T}) {ms:.4f} ms "
                  f"(HBM {gbs(ms, 4.5)}) {tag}", flush=True)
        for bits in (T, L - h0):
            x0, xphi = v0.clone(), phi.clone()
            ms = time_ms(lambda: cf._launch_iter(
                x0, v1, xphi, dmb, G, 2 * s, 0.13, w_hi, x0, L, T, bits), 20)
            print(f"{ctype} iteration pass tile={T} bits={bits} "
                  f"{ms:.4f} ms {tag}", flush=True)
        for tile in (T - 1, T, T + 1, T + 2):
            ms = time_ms(lambda: first(w_hi, tile, L - h0), 20)
            print(f"{ctype} setup pass tile={tile} bits={L - h0} "
                  f"{ms:.4f} ms {tag}", flush=True)
        for h in range(4, 9):
            ms = time_ms(lambda: cf._launch_high(v0, G, None, L, h), 20)
            print(f"{ctype} high pass h={h} {ms:.4f} ms ({gbs(ms, 2)}) "
                  f"{tag}", flush=True)
        for h in range(5, 9):
            for tile in (T, T + 1, T + 2):
                def setup():
                    w = cf._launch_high(v0, G, None, L, h)
                    return first(w, tile, L - h)

                ms = time_ms(setup, 20)
                got = setup()
                want = cf.cheby_flip_first_plain(v0, dmb, G, s, 0.81, -0.45)
                err = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
                print(f"{ctype} setup h={h} tile={tile} {ms:.4f} ms "
                      f"(max|d| vs plain {err:.1e}) {tag}", flush=True)
        del v0, v1, phi, dmb, w_hi, buf


# Builds of csrc/cheby_flip.cu with one tuning value changed by a text
# substitution (the shipped source has no build switches).
VARIANTS = {
    "base": [],
    "minblocks3": [("__launch_bounds__(kTiledThreads)",
                    "__launch_bounds__(kTiledThreads, 3)")],
    "minblocks4": [("__launch_bounds__(kTiledThreads)",
                    "__launch_bounds__(kTiledThreads, 4)")],
    "batch8": [("kLoadBatch = 4;", "kLoadBatch = 8;")],
    "threads256": [("kTiledThreads = 512;", "kTiledThreads = 256;"),
                   ("__launch_bounds__(kTiledThreads)",
                    "__launch_bounds__(kTiledThreads, 8)")],
    "threads1024": [("kTiledThreads = 512;", "kTiledThreads = 1024;")],
}


def build_variants(out_dir):
    import ctypes
    import subprocess

    sys.path.insert(0, str(HERE))
    from quantumpropagators_torch.ops import _cuda

    src = (HERE / "quantumpropagators_torch/csrc/cheby_flip.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise ValueError(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        regs = [ln.split(":")[-1].strip() for ln in err.splitlines()
                if "registers" in ln]
        print(f"variant {name}: ptxas {regs}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn, argtypes in _cuda._SIGNATURES.items():
            if fn.startswith("cheby_flip"):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def variants():
    sys.path.insert(0, str(HERE))
    from chip_smoke import kernel_inputs, time_ms
    from quantumpropagators_torch.ops import cheby_flip as cf

    dev = torch.device("cuda", 0)
    libs = build_variants(HERE / "quantumpropagators_torch" / "_build"
                          / "variants")
    tag = f"[{card()}]"
    stream = torch.cuda.current_stream(dev).cuda_stream
    for ctype, sfx in (("double", "f64"), ("float", "f32")):
        v0, v1, phi, dmb, G, s = kernel_inputs(L, ctype, dev, SEED)
        T, h0 = cf.flip_split(L, v0.dtype)
        n = v0.numel()
        want = cf.cheby_flip_first_plain(v0, dmb, G, s, 0.81, -0.45)
        for name, lib in libs.items():
            first_fn = getattr(lib, f"cheby_flip_first_{sfx}")
            high_fn = getattr(lib, f"cheby_flip_high_{sfx}")
            iter_fn = getattr(lib, f"cheby_flip_iter_{sfx}")

            def setup(h, tile):
                w = torch.empty_like(v0)
                rc = high_fn(v0.data_ptr(), G.data_ptr(), None, None, 0,
                             w.data_ptr(), L, n, h,
                             cf._line_bits(L, h, v0.dtype), stream)
                out, p = torch.empty_like(v0), torch.empty_like(v0)
                rc |= first_fn(v0.data_ptr(), out.data_ptr(), p.data_ptr(),
                               dmb.data_ptr(), G.data_ptr(), w.data_ptr(), L,
                               n, tile, L - h, s, 0.81, -0.45, stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
                return out, p

            got = setup(h0, T)
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            res = []
            for h in (6, 8):
                for tile in (T, T + 1, T + 2):
                    res.append(f"h={h},T={tile}:"
                               f"{time_ms(lambda: setup(h, tile), 20):.4f}")
            w_hi = cf._launch_high(v1, G, None, L, h0)
            x0, xphi = v0.clone(), phi.clone()

            def order():
                rc = iter_fn(x0.data_ptr(), x0.data_ptr(), v1.data_ptr(),
                             xphi.data_ptr(), dmb.data_ptr(), G.data_ptr(),
                             w_hi.data_ptr(), L, n, T, L - h0, 2 * s, 0.13,
                             stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")

            it = time_ms(order, 20)
            print(f"{ctype} variant {name}: setup ms {' '.join(res)}; "
                  f"iteration pass h={h0},T={T}: {it:.4f}; setup max|d| vs "
                  f"plain {err:.1e} {tag}", flush=True)
        del v0, v1, phi, dmb, want


def main_path(root):
    sys.path.insert(0, str(root))
    import quantumpropagators_torch as qt
    from quantumpropagators_torch.ops.cheby import ChebyWorkspace

    dev = torch.device("cuda", 0)
    n_steps, dt = 20, 0.05
    H_diag, H_x = qt.transverse_field_ising(L, J=1.0, g=1.2, h=0.3,
                                            dtype=torch.complex128,
                                            device=dev)
    T = n_steps * dt
    H = qt.hamiltonian(H_diag, (H_x, lambda t: qt.flattop(
        t, T=T, t_rise=0.3 * T)))
    # the envelope and padding of chip_smoke.py's workspace: 16 orders
    wrk = ChebyWorkspace.create(76.914316, -35.586582, dt, pad_to=8)
    assert len(wrk.coeffs) == 16
    rng = np.random.default_rng(SEED + 10)
    psi = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi0 = torch.as_tensor(psi / np.linalg.norm(psi)).to(dev)
    tlist = np.linspace(0.0, n_steps * dt, n_steps + 1)
    for kernel, p0 in (("dd", psi0), ("pallas", psi0.to(torch.complex64))):
        rates = []
        for _ in range(4):
            t0 = time.perf_counter()
            qt.propagate(p0, H, tlist, method="cheby", fused=True,
                         kernel=kernel, workspace=wrk)
            torch.cuda.synchronize()
            rates.append(n_steps / (time.perf_counter() - t0))
        print(f"main {root.name or root} {kernel}: steps/s "
              f"{' '.join(f'{r:.3f}' for r in rates[1:])} (first run "
              f"{rates[0]:.3f} dropped) [{card()}]", flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("flip_setup_sweep: no CUDA device")
    if sys.argv[1] == "sweep":
        sweep()
    elif sys.argv[1] == "variants":
        variants()
    else:
        main_path(Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else HERE)
