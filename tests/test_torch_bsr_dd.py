"""Port vs JAX package: the banded block operator and its SpMV
(``ops/bsr_dd.py`` + ``ops/banded_spmv.py`` against
``ops/bsr_dd_pallas.py``), mirroring ``tests/test_bsr_dd_pallas.py``.

The port's SpMV wrapper runs its plain PyTorch version on these CPU
tensors; the JAX Pallas kernel runs in interpret mode at b = 8, as the
JAX package's own tests run it.  The Chebyshev test uses a generic
envelope (β = Δ/2 + E_min ≠ 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch

from quantumpropagators.ops import bsr_dd_pallas as jbd
from quantumpropagators.ops.cheby import cheby_coeffs
from quantumpropagators.ops.df64 import CDD, DD
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch.ops import banded_spmv as bs
from quantumpropagators_torch.ops import bsr_dd as tbd

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")

B, TR = 8, 4


def dds(v):
    v = np.asarray(v, np.float64)
    hi = v.astype(np.float32)
    return DD(jnp.asarray(hi),
              jnp.asarray((v - hi.astype(np.float64)).astype(np.float32)))


def undd(x):
    return np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(5)
    N = 96
    A = sp.diags(
        [rng.normal(size=N - 2), rng.normal(size=N - 1),
         rng.normal(size=N), rng.normal(size=N - 1),
         rng.normal(size=N - 2)],
        [-2, -1, 0, 1, 2],
    ).tocsr()
    A = (0.5 * (A + A.T)).tocsr()
    x = rng.normal(size=N) + 1j * rng.normal(size=N)
    return A, N, x


def _jax_apply(jop, x, **kw):
    """The JAX kernel on both components of a complex ``x``."""
    re = jbd.banded_dd_apply(jop, dds(x.real), interpret=True, **kw)
    im = jbd.banded_dd_apply(jop, dds(x.imag), interpret=True, **kw)
    return undd(re) + 1j * undd(im)


def test_banded_reblock_layout(problem):
    A, N, _ = problem
    op = tbd.banded_dd_from_scipy(A, block=B)
    jop = jbd.banded_dd_from_scipy(A, block=B)
    assert op.offsets == jop.offsets == (-1, 0, 1)
    assert (op.R, op.b, op.shape) == (jop.R, jop.b, jop.shape) == (N // B, B, (N, N))
    assert op.logical_nnz == jop.logical_nnz == A.nnz
    assert op.planes.dtype == torch.float64
    planes = op.planes.numpy()
    # the hi + lo split of the JAX planes carries the same values to 2^-48
    assert np.abs(planes - from_jax(jop).planes.numpy()).max() < 1e-14
    dense = np.zeros((N, N))
    for k, d in enumerate(op.offsets):
        for r in range(op.R):
            c = r + d
            if 0 <= c < op.R:
                dense[r * B:(r + 1) * B, c * B:(c + 1) * B] = planes[k, :, r, :].T
    assert np.abs(dense - A.toarray()).max() < 1e-14


def test_banded_apply_matches_jax(problem):
    A, N, x = problem
    op = tbd.banded_dd_from_scipy(A, block=B)
    jop = jbd.banded_dd_from_scipy(A, block=B)
    bs.reset_launches()
    got = bs.banded_dd_apply(op, torch.as_tensor(x), tile_rows=TR).numpy()
    assert bs.LAUNCHES["banded_spmv<double>"] == 0  # plain version on CPU
    want = _jax_apply(jop, x, tile_rows=TR)
    ref = A @ x
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-13
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-13


def test_banded_apply_extended_matches_jax(problem):
    """Halo mode: the local rows with one ``tile_rows``-row halo on
    each side, filled here with another state's rows."""
    A, N, x = problem
    op = tbd.banded_dd_from_scipy(A, block=B)
    jop = jbd.banded_dd_from_scipy(A, block=B)
    halo = np.random.default_rng(6).normal(size=(2, TR * B))
    x_ext = np.concatenate([halo[0], x, halo[1]])
    got = bs.banded_dd_apply_extended(op, torch.as_tensor(x_ext),
                                      tile_rows=TR).numpy()
    re = jbd.banded_dd_apply_extended(jop, dds(x_ext.real), tile_rows=TR,
                                      interpret=True)
    im = jbd.banded_dd_apply_extended(jop, dds(x_ext.imag), tile_rows=TR,
                                      interpret=True)
    want = undd(re) + 1j * undd(im)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-13
    # the edge blocks of A's planes are zero, so the halo adds nothing
    ref = A @ x
    assert np.abs(got - ref).max() < 1e-13 * np.abs(ref).max()
    # a cross-shard block in band -1 of row 0 reads the last halo row
    planes = op.planes.clone()
    edge = np.random.default_rng(7).normal(size=(B, B))
    planes[0, :, 0, :] = torch.as_tensor(edge)
    got2 = bs.banded_spmv(planes, op.offsets, torch.as_tensor(x_ext),
                          halo=TR).numpy()
    ref2 = ref.copy()
    ref2[:B] += edge.T @ halo[0][-B:]
    assert np.abs(got2 - ref2).max() < 1e-13 * np.abs(ref2).max()
    with pytest.raises(ValueError, match="not divisible by tile_rows"):
        bs.banded_dd_apply_extended(op, torch.as_tensor(x_ext), tile_rows=5)


def test_banded_cheby_reference_accuracy(problem):
    A, N, _ = problem
    op = tbd.banded_dd_from_scipy(A, block=B)
    jop = jbd.banded_dd_from_scipy(A, block=B)
    bound = float(np.abs(A).sum(axis=1).max())
    # generic envelope: β = Δ/2 + E_min = 0.05·bound ≠ 0
    delta, e_min, dt = 2.3 * bound, -1.1 * bound, 0.3
    c64 = cheby_coeffs(delta, dt)
    rng = np.random.default_rng(8)
    psi = rng.normal(size=N) + 1j * rng.normal(size=N)
    psi /= np.linalg.norm(psi)
    got = tbd.cheby_apply_dd_banded(op, torch.as_tensor(psi), c64, delta,
                                    e_min, dt, tile_rows=TR).numpy()
    U = scipy.linalg.expm(-1j * A.toarray() * dt)
    assert np.abs(got - U @ psi).max() < 1e-12
    out = jbd.cheby_apply_dd_banded(
        jop, CDD(dds(psi.real), dds(psi.imag)), c64, delta, e_min, dt,
        tile_rows=TR, interpret=True,
    )
    want = undd(out.re) + 1j * undd(out.im)
    assert np.abs(got - want).max() < 1e-12
    # backward reverses forward
    back = tbd.cheby_apply_dd_banded(op, torch.as_tensor(got), c64, delta,
                                     e_min, -dt).numpy()
    assert np.abs(back - psi).max() < 1e-12


def test_banded_rejects_non_banded():
    rng = np.random.default_rng(0)
    A = sp.random(256, 256, density=0.05, random_state=rng)
    A = (A + A.T).tocsr()
    with pytest.raises(ValueError, match="not a banded operator") as tinfo:
        tbd.banded_dd_from_scipy(A, block=B, max_bands=5)
    with pytest.raises(ValueError, match="not a banded operator") as jinfo:
        jbd.banded_dd_from_scipy(A, block=B, max_bands=5)
    assert str(tinfo.value).split(":")[0] == str(jinfo.value).split(":")[0]
    with pytest.raises(ValueError, match="real entries"):
        tbd.banded_dd_from_scipy(1j * A, block=B)


def test_banded_single_tile_operator(problem):
    """An operator that fits in one tile (tile_rows = R) with nonzero
    band offsets applies correctly in both window modes."""
    A, N, x = problem
    op = tbd.banded_dd_from_scipy(A, block=B)
    jop = jbd.banded_dd_from_scipy(A, block=B)
    got = bs.banded_dd_apply(op, torch.as_tensor(x), tile_rows=op.R).numpy()
    want = _jax_apply(jop, x, tile_rows=op.R)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-13
    x_ext = np.concatenate([np.zeros(op.R * B), x, np.zeros(op.R * B)])
    ext = bs.banded_dd_apply_extended(op, torch.as_tensor(x_ext),
                                      tile_rows=op.R).numpy()
    assert np.abs(ext - got).max() == 0.0


def test_wrapper_validates_arguments(problem):
    A, N, x = problem
    op = tbd.banded_dd_from_scipy(A, block=B)
    xt = torch.as_tensor(x)
    with pytest.raises(TypeError, match="complex128"):
        bs.banded_spmv(op.planes, op.offsets, xt.to(torch.complex64))
    with pytest.raises(ValueError, match="entries, expected"):
        bs.banded_spmv(op.planes, op.offsets, xt[:-B])
    with pytest.raises(ValueError, match="one offset per band"):
        bs.banded_spmv(op.planes, op.offsets[:2], xt)
    with pytest.raises(ValueError, match="float64"):
        bs.banded_spmv(op.planes.float(), op.offsets, xt)
    with pytest.raises(ValueError, match="exceeds tile_rows"):
        bs.banded_spmv(op.planes, (-2, 0, 2), torch.zeros(
            (op.R + 2) * B, dtype=torch.complex128), halo=1)
