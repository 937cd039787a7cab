"""The sharded steps on the card against the same calls on CPU tensors:
the 4-slot sharded reference-tier flip step at L = 20, both tiers on 32
slots at L = 19 (five slot-bit partners a pass), and the 4-slot
sharded banded step at 2^16 (b = 128), each ≤ 1e-12, with their kernel
launch counts, and Newton through ``DistributedBSR`` on 4 slots at
2^14 (≤ 1e-12).  Needs an NVIDIA GPU with nvcc (``-m cuda``); skips
without one.  Imports no jax: run with ``--noconftest``."""

import numpy as np
import pytest
import torch

import quantumpropagators_torch as qt
from quantumpropagators_torch.ops import banded_spmv as bs
from quantumpropagators_torch.ops import cheby_flip as cf
from quantumpropagators_torch.ops.bsr_dd import BandedDD
from quantumpropagators_torch.ops.cheby import cheby_coeffs
from quantumpropagators_torch.parallel import sharded_banded as sbd
from quantumpropagators_torch.parallel import sharded_fused as sf
from quantumpropagators_torch.parallel.mesh import chain_mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _state(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n) + 1j * rng.normal(size=n)
    return torch.as_tensor(v / np.linalg.norm(v))


def test_sharded_dd_step_on_card_matches_cpu(cuda):
    """One step with a per-bit flip scale and the f32 tail: every slot
    bit exchanged, 4 slots of 2^18."""
    L, g = 20, 1.2
    H_diag, _ = qt.transverse_field_ising(L, J=1.0, g=g, h=0.3,
                                          dtype=torch.float64, device="cpu")
    bound = (L - 1) + 0.3 * L + g * L
    e_min, delta, dt = -bound, 2 * bound, 0.05
    coeffs = cheby_coeffs(delta, dt)
    dmb = H_diag.diag - (delta / 2 + e_min)
    psi = _state(2 ** L, 11)
    fs = torch.as_tensor(np.random.default_rng(12).uniform(0.5, 1.5, L))
    out = {}
    for dev in ("cpu", cuda):
        step = sf.make_sharded_fused_cheby_step_dd(
            chain_mesh(4, device=dev), L, g, delta=delta, e_min=e_min, dt=dt)
        cf.reset_launches()
        out[str(dev)] = step(dmb.to(dev), psi.to(dev), coeffs,
                             flip_scale=fs.to(dev)).cpu()
        if dev != "cpu":
            torch.cuda.synchronize()
            counts = dict(cf.LAUNCHES)
    tail = step.exchange_plan["f32_tail_orders"]
    n_dd = len(coeffs) - tail
    assert tail > 0
    assert counts["cheby_flip_first<double>"] == 4
    assert counts["cheby_flip_iter<double>"] == 4 * (n_dd - 2)
    assert counts["cheby_flip_iter<float>"] == 4 * tail
    # a high pass before every tiled pass: the slot bits' partners are
    # summed there, also where the slot's split has no top bits (h = 0)
    assert cf.flip_split(L - 2, torch.complex128)[1] == 0
    for ctype, n in (("double", n_dd - 1), ("float", tail)):
        assert counts[f"cheby_flip_high<{ctype}>"] == 4 * n
    assert float((out["cpu"] - out[str(cuda)]).abs().max()) < 1e-12


def test_sharded_f32_step_on_card_matches_cpu(cuda):
    """One complex64 step under a flip scale, 4 slots of 2^18, one slot
    bit coupled and one not: one partner per product, read by a high
    pass before every tiled pass, and the card agrees with the CPU to
    1e-5 of the largest amplitude."""
    L = 20
    g = np.full(L, 1.2)
    g[L - 2] = 0.0  # slot bit 0 uncoupled
    H_diag, _ = qt.transverse_field_ising(L, J=1.0, g=1.2, h=0.3,
                                          dtype=torch.float64, device="cpu")
    bound = (L - 1) + 0.3 * L + 1.2 * L
    e_min, delta, dt = -bound, 2 * bound, 0.05
    coeffs = cheby_coeffs(delta, dt)
    diag = H_diag.diag.to(torch.float32)
    psi = _state(2 ** L, 15).to(torch.complex64)
    out = {}
    for dev in ("cpu", cuda):
        mesh = chain_mesh(4, device=dev)
        step = sf.make_sharded_fused_cheby_step(
            mesh, L, g, delta=delta, e_min=e_min, dt=dt)
        cf.reset_launches()
        re, im = step(diag.to(dev), psi.real.contiguous().to(dev),
                      psi.imag.contiguous().to(dev), coeffs, 0.8)
        out[str(dev)] = torch.complex(re, im).cpu()
    assert cf.LAUNCHES["cheby_flip_first<float>"] == 4
    assert cf.LAUNCHES["cheby_flip_iter<float>"] == 4 * (len(coeffs) - 2)
    assert cf.LAUNCHES["cheby_flip_high<float>"] == 4 * (len(coeffs) - 1)
    want = out["cpu"]
    err = float((out[str(cuda)] - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


def test_sharded_steps_on_32_slots_match_cpu(cuda):
    """Both tiers on 32 slots of 2^14 (L = 19): five slot bits, every
    one a partner of each high pass (at h = 0 here), one launch a slot
    and pass; the dd step with a per-bit flip scale and its f32 tail to
    1e-12 of the CPU, the f32 step to 1e-5 of the largest amplitude."""
    L, g, slots = 19, 1.2, 32
    H_diag, _ = qt.transverse_field_ising(L, J=1.0, g=g, h=0.3,
                                          dtype=torch.float64, device="cpu")
    bound = (L - 1) + 0.3 * L + g * L
    e_min, delta, dt = -bound, 2 * bound, 0.05
    coeffs = cheby_coeffs(delta, dt)
    dmb = H_diag.diag - (delta / 2 + e_min)
    psi = _state(2 ** L, 17)
    fs = torch.as_tensor(np.random.default_rng(18).uniform(0.5, 1.5, L))
    p32 = psi.to(torch.complex64)
    out, counts = {}, {}
    for dev in ("cpu", cuda):
        mesh = chain_mesh(slots, device=dev)
        step = sf.make_sharded_fused_cheby_step_dd(
            mesh, L, g, delta=delta, e_min=e_min, dt=dt)
        step32 = sf.make_sharded_fused_cheby_step(
            mesh, L, g, delta=delta, e_min=e_min, dt=dt)
        cf.reset_launches()
        dd = step(dmb.to(dev), psi.to(dev), coeffs, flip_scale=fs.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            counts["dd"] = dict(cf.LAUNCHES)
            cf.reset_launches()
        re, im = step32(H_diag.diag.to(dev, torch.float32),
                        p32.real.contiguous().to(dev),
                        p32.imag.contiguous().to(dev), coeffs, 0.8)
        if dev != "cpu":
            torch.cuda.synchronize()
            counts["f32"] = dict(cf.LAUNCHES)
        out[str(dev)] = dd.cpu(), torch.complex(re, im).cpu()
    tail = step.exchange_plan["f32_tail_orders"]
    n_dd = len(coeffs) - tail
    assert step.exchange_plan["live_device_bits"] == 5 and tail > 0
    assert cf.flip_split(L - 5, torch.complex128)[1] == 0
    assert counts["dd"]["cheby_flip_first<double>"] == slots
    assert counts["dd"]["cheby_flip_high<double>"] == slots * (n_dd - 1)
    assert counts["dd"]["cheby_flip_high<float>"] == slots * tail
    assert counts["f32"]["cheby_flip_high<float>"] == slots * (
        len(coeffs) - 1)
    (dd_cpu, f_cpu), (dd_card, f_card) = out["cpu"], out[str(cuda)]
    assert float((dd_cpu - dd_card).abs().max()) < 1e-12
    assert float((f_cpu - f_card).abs().max()) <= 1e-5 * float(
        f_cpu.abs().max())


def test_sharded_banded_step_on_card_matches_cpu(cuda):
    """Random band planes (offsets -1, 0, 1; b = 128, R = 512) over 4
    slots: the clamped kernel per slot plus the edge correction."""
    b, R = 128, 512
    g = torch.Generator().manual_seed(13)
    planes = torch.randn((3, b, R, b), generator=g, dtype=torch.float64)
    planes /= np.sqrt(3 * b)
    planes[0, :, 0, :] = 0.0   # no block left of row 0
    planes[2, :, -1, :] = 0.0  # nor right of row R - 1
    op = BandedDD(planes=planes, offsets=(-1, 0, 1), R=R, b=b,
                  shape=(R * b, R * b))
    psi = _state(R * b, 14)
    bound = float(3 * planes.abs().sum(dim=1).max()) + 1.0
    e_min, delta, dt = -bound, 2 * bound, 0.05
    coeffs = cheby_coeffs(delta, dt)
    out = {}
    for dev in ("cpu", cuda):
        mesh = chain_mesh(4, device=dev)
        opd = BandedDD(planes=planes.to(dev), offsets=op.offsets, R=R, b=b,
                       shape=op.shape)
        pb, step, kind = sbd.make_sharded_dd_cheby_step(
            mesh, opd, 4, delta=delta, e_min=e_min, dt=dt)
        assert kind == "banded_pallas"
        bs.reset_launches()
        out[str(dev)] = step(pb, psi.to(dev), coeffs).cpu()
    assert bs.LAUNCHES["banded_spmv<double>"] == 4 * (len(coeffs) - 1)
    assert float((out["cpu"] - out[str(cuda)]).abs().max()) < 1e-12


def test_distributed_bsr_newton_on_card_matches_cpu(cuda):
    """Newton (restarted Arnoldi, reductions over the mesh's psum) through
    DistributedBSR on 4 slots of a 2^14 block-tridiagonal operator
    (b = 128, halo mode), the result kept in the (4, 2^12) layout."""
    from quantumpropagators_torch.ops.newton import newton_apply
    from quantumpropagators_torch.parallel.mesh import shard_vector
    from quantumpropagators_torch.parallel.sharded_bsr import (
        DistributedBSR, partition_bsr)

    b, R = 128, 128
    g = torch.Generator().manual_seed(5)
    D = torch.randn((R, b, b), generator=g, dtype=torch.float64)
    U = torch.randn((R, b, b), generator=g, dtype=torch.float64)
    blocks = torch.stack([U.transpose(1, 2), 0.5 * (D + D.transpose(1, 2)),
                          U.roll(-1, 0)], 1) / np.sqrt(3 * b)
    r = torch.arange(R)
    cols = torch.stack([r - 1, r, r + 1], 1)
    blocks[0, 0] = blocks[-1, 2] = 0.0  # no wrap-around coupling
    cols = cols.clamp(0, R - 1)
    A = qt.BSROperator(blocks=blocks, cols=cols, shape=(R * b, R * b),
                       block_size=b)
    psi = _state(R * b, 21)
    out = {}
    for dev in ("cpu", cuda):
        mesh = chain_mesh(4, device=dev)
        op = DistributedBSR(mesh, partition_bsr(A, 4, device=dev))
        assert op.pbsr.halo_blocks == 1
        got = newton_apply(op, shard_vector(mesh, psi), 0.2, m_max=12)
        assert got.shape == (4, R * b // 4) and got.device.type == \
            torch.device(dev).type
        out[str(dev)] = got.cpu()
    assert float((out["cpu"] - out[str(cuda)]).abs().max()) <= 1e-12
