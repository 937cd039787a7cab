"""What the card's arithmetic does exactly: the port of
``docs/profiling/scratch_r3_probe2.py`` and ``scratch_r3_probe3.py``
(FMA contraction), ``scratch_r3_probe4.py`` (σ-extraction, σ-aligned
tile products, the grouped row roll), ``scratch_flips.py``'s permutation
products and ``probe_mxu_grid_r4.py`` (tensor-core exactness against
mantissa width).

    python -m quantumpropagators_torch.profiling.exactness

- FMA: ``p = a·b; r = a·b − p`` in float32 and float64 as the kernel
  library's ``nvcc`` flags compile it: ``FUSED`` (``r`` is the exact
  residual: the compiler contracted ``a·b − p`` into one FMA) or
  ``separate`` (``r = 0``).  Written inline, as the TPU probe is, the
  compiler may also evaluate ``a·b`` once (``r = 0`` again), so the
  contraction is read from the ``loaded`` variant, where ``a``, ``b``
  and ``p`` come back through volatile loads.  The same with ``__fmul_rn``/
  ``__fsub_rn`` must read ``separate``.  Any other reading raises.
- σ-extraction: ``q = (σ + x) − σ`` with ``σ = 64·max|x|`` is ``kept``
  (the strict float32 value) or ``FOLDED`` (``q = x``); anything else
  raises.
- Tile products on the tensor cores (``probe_tile_mma``) in TF32, 3xTF32
  and FP64: a permutation and the 7-bit adjacency on a wide-range tile,
  σ-aligned values, and values on a ``k``-bit grid for ``k`` in
  ``GRID_BITS``, each against the exact float64 product.
- ``x[i ^ 2^j]`` through shared memory (the TPU's grouped row roll) and
  by warp shuffles: exact or not.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import probes
from . import card_line, cuda_device

LANE = 128
GRID_BITS = (4, 7, 8, 12, 16, 24)
MODES = ("tf32", "3xtf32", "f64")


def adjacency() -> np.ndarray:
    """The 7-bit lane-flip adjacency ``A01[l ^ 2^j, l] = 1``, j < 7."""
    A = np.zeros((LANE, LANE), np.float32)
    idx = np.arange(LANE)
    for j in range(7):
        A[idx ^ (1 << j), idx] += 1.0
    return A


def permutation(bit: int = 0) -> np.ndarray:
    """``P[l ^ 2^bit, l] = 1``: ``x @ P`` flips lane bit ``bit``."""
    P = np.zeros((LANE, LANE), np.float32)
    idx = np.arange(LANE)
    P[idx ^ (1 << bit), idx] = 1.0
    return P


def tf32_ties(shape, seed: int = 0) -> np.ndarray:
    """Standard normal float32 values moved onto a TF32 rounding tie: low
    13 bits ``0x1000``, halfway between two TF32 values, where rounding
    to nearest with ties away (``cvt.rna``, the plain version's
    ``tf32_round``) and truncation (what the tensor cores do to an
    operand left unrounded) differ."""
    v = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return ((v.view(np.int32) & ~0x1FFF) | 0x1000).view(np.float32)


def grid_values(v: np.ndarray, k: int) -> np.ndarray:
    """``v`` (float32, |v| ≤ 1) rounded to multiples of ``2^-k`` by
    ``(v + c) − c`` in float32, ``c = 1.5·2^23·2^-k``, as
    ``probe_mxu_grid_r4.py`` makes its inputs."""
    g = np.float32(2.0 ** -k)
    c = np.float32(1.5 * 2.0 ** 23) * g
    return ((v + c) - c).astype(np.float32)


def product_error(x: np.ndarray, M: np.ndarray, mode: str, device):
    """``x @ M`` by ``probe_tile_mma`` in ``mode`` (rows padded to a
    multiple of 16 with zeros) against the exact float64 product; returns
    ``(max abs error, max |exact|)``."""
    rows = x.shape[0]
    xp = np.zeros((-(-rows // 16) * 16, LANE), np.float32)
    xp[:rows] = x
    dtype = torch.float64 if mode == "f64" else torch.float32
    xt = torch.from_numpy(xp).to(device, dtype)
    Mt = torch.from_numpy(M).to(device, dtype)
    got = probes.probe_tile_mma(xt, Mt, mode)[:rows].double().cpu().numpy()
    exact = x.astype(np.float64) @ M.astype(np.float64)
    return float(np.abs(got - exact).max()), float(np.abs(exact).max())


def fma_probe(device, seed=0, log=print):
    """FMA contraction in float32 and float64; returns ``{ctype:
    {variant: outcome, "max|r|": {variant: ...}}}`` for each variant of
    ``probes.FMA_VARIANTS``; ``"loaded"`` is the contraction finding."""
    card = card_line()
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((8, LANE)).astype(np.float32) \
        * np.float32(1.000001)
    ys = rng.standard_normal((8, LANE)).astype(np.float32) \
        * np.float32(0.999999)
    # float64 operands with full 53-bit mantissas: float32 values would
    # make every float64 product exact and r = 0 either way
    x64 = rng.standard_normal((8, LANE)) * 1.000001
    y64 = rng.standard_normal((8, LANE)) * 0.999999
    res = {}
    for ctype, (a, b) in (("float", (xs, ys)), ("double", (x64, y64))):
        a = torch.from_numpy(a).to(device)
        b = torch.from_numpy(b).to(device)
        row = res[ctype] = {"max|r|": {}}
        for variant in probes.FMA_VARIANTS:
            p, r = probes.probe_fma_residual(a, b, variant)
            what = row[variant] = probes.fma_outcome(a, b, p, r)
            row["max|r|"][variant] = float(r.abs().max())
            if what == "OTHER" or (variant == "separate"
                                   and what != "separate"):
                raise AssertionError(f"FMA probe {ctype} {variant}: {what}")
            resid = (r - probes.exact_product_residual(a, b)).abs().max()
            log(f"exactness FMA {ctype} {variant}: max|r| "
                f"{float(r.abs().max()):.3e}, max|r - exact residual| "
                f"{float(resid):.3e} -> {what} [{card}]")
    return res


def sigma_probes(device, seed=0, log=print):
    """``scratch_r3_probe4.py`` on the card: σ-extraction, the σ-aligned
    (8, 128) × A01 product in each mode, and the grouped row roll
    ``x[i ^ 2^8]`` of a (32, 128) plane (and a lane flip by shuffles)."""
    card = card_line()
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((8, LANE))
         * np.exp(rng.uniform(-8, 3, (8, LANE)))).astype(np.float32)
    xt = torch.from_numpy(x).to(device)
    q, _ = probes.probe_extract(xt)
    outcome = probes.extract_outcome(xt, q)
    if outcome == "OTHER":
        raise AssertionError("σ-extraction probe: neither kept nor folded")
    m = np.max(np.abs(x))
    sigma = np.float32(64.0 * m)
    q_ref = np.float32(np.float32(sigma + x) - sigma)
    qn = q.cpu().numpy()
    log(f"exactness extract: max|q - q_ref| = {np.abs(qn - q_ref).max():.3e}"
        f" (0 => no folding); max|q - x| = {np.abs(qn - x).max():.3e} "
        f"(0 => FOLDED) -> {outcome} [{card}]")
    res = {"extract": outcome, "dot": {}}
    eps = np.float32(sigma * 2.0 ** -24)
    aligned = (np.round(x / eps) * eps).astype(np.float32)
    A = adjacency()
    for mode in MODES:
        err, scale = product_error(aligned, A, mode, device)
        res["dot"][mode] = {"abs": err, "rel": err / max(scale, 1e-30)}
        log(f"exactness σ-aligned (8, 128) x A01 {mode:6s}: abs err "
            f"{err:.3e} rel {err / max(scale, 1e-30):.3e} [{card}]")
    xr = rng.standard_normal((32, LANE)).astype(np.float32)
    xr_t = torch.from_numpy(xr).to(device)
    idx = np.arange(32)
    roll = np.abs(probes.probe_xor_permute(xr_t, 8, "smem").cpu().numpy()
                  - xr[idx ^ 2]).max()
    lanes = np.arange(xr.size)
    shfl = np.abs(probes.probe_xor_permute(xr_t, 2, "shfl").cpu().numpy()
                  .reshape(-1) - xr.reshape(-1)[lanes ^ 4]).max()
    res["roll"] = {"smem": float(roll), "shfl": float(shfl)}
    log(f"exactness grouped roll x[i ^ 2^8] through shared memory: max err "
        f"= {roll} (0 => exact XOR); x[i ^ 2^2] by warp shuffle: max err "
        f"= {shfl} [{card}]")
    return res


def permutation_products(device, seed=0, log=print):
    """``scratch_flips.py``'s probe on the card: one wide-range (512, 128)
    tile times a permutation (exact?) and times A01 (max relative
    error), per mode."""
    card = card_line()
    rng = np.random.default_rng(seed)
    rng.standard_normal((1 << 13, LANE))  # the script's timing plane
    xt = (rng.standard_normal((512, LANE))
          * np.exp(rng.uniform(-30, 30, (512, LANE)))).astype(np.float32)
    res = {}
    for mode in MODES:
        perm, _ = product_error(xt, permutation(0), mode, device)
        dtype = torch.float64 if mode == "f64" else torch.float32
        got = probes.probe_tile_mma(
            torch.from_numpy(xt).to(device, dtype),
            torch.from_numpy(adjacency()).to(device, dtype),
            mode).double().cpu().numpy()
        exact = xt.astype(np.float64) @ adjacency().astype(np.float64)
        rel = float(np.max(np.abs(got - exact) / (np.abs(exact) + 1e-300)))
        abs_x = float(np.abs(got - exact).max() / np.abs(xt).max())
        res[mode] = {"perm_exact": perm == 0.0, "A01_rel": rel,
                     "A01_abs/xmax": abs_x}
        log(f"exactness perm matmul {mode:6s} exact: {perm == 0.0} "
            f"(max err {perm:.3e}); A01: max rel err {rel:.2e}, max "
            f"abs/xmax {abs_x:.2e} [{card}]")
    return res


def mantissa_grid(device, seed=0, log=print):
    """``probe_mxu_grid_r4.py`` on the card: max |product − exact| of a
    (1024, 128) × A01 product of values on a ``k``-bit grid, per mode."""
    card = card_line()
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1.0, 1.0, size=(1024, LANE)).astype(np.float32)
    A = adjacency()
    res = {}
    for k in GRID_BITS:
        q = grid_values(v, k)
        res[k] = row = {}
        for mode in MODES:
            err, _ = product_error(q, A, mode, device)
            row[mode] = err
            log(f"exactness k={k:2d} bits, {mode:6s}: max err = {err:.3e} "
                f"({'EXACT' if err == 0.0 else 'inexact'}) [{card}]")
    return res


def run(device, seed=0, log=print):
    return {"fma": fma_probe(device, seed, log),
            "sigma": sigma_probes(device, seed, log),
            "permutation": permutation_products(device, seed, log),
            "grid": mantissa_grid(device, seed, log)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    return run(cuda_device())


if __name__ == "__main__":
    main()
