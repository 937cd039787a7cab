"""Port vs JAX package: ``kernel="dd"`` on static operators without flip
structure (the port's ``fused._static_dd_path`` against the JAX
package's), mirroring the ``test_dd_static_*`` tests of
``tests/test_fused.py``.

On the CPU the banded route runs the SpMV's plain version at b = 8 (the
JAX package's CPU block size; its Pallas kernel runs in interpret
mode).  Envelopes are generic (β = Δ/2 + E_min ≠ 0): the default
Arnoldi specrange, seeded, or a manual one with E_min ≠ −Δ/2."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch

import quantumpropagators_torch as qt
from quantumpropagators.fused import cheby_propagate_fused as jax_fused
from quantumpropagators.models.generators import Operator as JOperator
from quantumpropagators.ops import operators as jops
from quantumpropagators.ops.cheby import ChebyWorkspace as JWorkspace
from quantumpropagators.utils.fixtures import random_state_vector
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.fused import cheby_propagate_fused
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch.models.generators import Operator
from quantumpropagators_torch.ops import banded_spmv as bs
from quantumpropagators_torch.ops import bsr_dd
from quantumpropagators_torch.ops.cheby import ChebyWorkspace
from quantumpropagators_torch.ops.operators import to_scipy_sparse

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")


@pytest.fixture(scope="module")
def banded_problem():
    rng = np.random.default_rng(91)
    N = 48
    A = sp.diags(
        [rng.normal(size=N - 2), rng.normal(size=N - 1),
         rng.normal(size=N), rng.normal(size=N - 1),
         rng.normal(size=N - 2)],
        [-2, -1, 0, 1, 2],
    ).tocsr()
    A = (0.5 * (A + A.T)).tocsr()
    psi0 = random_state_vector(N, rng=rng)
    tlist = np.linspace(0, 0.5, 11)
    return A, psi0, tlist


def _expm_final(A, psi0, tlist):
    U = scipy.linalg.expm(-1j * (tlist[-1] - tlist[0]) * A.toarray())
    return U @ psi0


def _nonbanded(A):
    N = A.shape[0]
    A = A.tolil()
    A[0, N - 1] = A[N - 1, 0] = 0.4
    return A.tocsr()


def _count_spmv(monkeypatch):
    """Count the banded SpMV's calls (its plain version, on the CPU)."""
    calls = []
    orig = bs.banded_spmv_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(bs, "banded_spmv_plain", counted)
    return calls


def test_dd_static_banded_via_propagate(banded_problem, monkeypatch):
    """propagate(fused=True, kernel='dd') on a banded BSR operator rides
    the banded SpMV, once per matvec, at reference accuracy."""
    A, psi0, tlist = banded_problem
    op = qt.bsr_from_scipy(A, block_size=8)
    calls = _count_spmv(monkeypatch)
    got = qt.propagate(torch.as_tensor(psi0), op, tlist, method="cheby",
                       fused=True, kernel="dd", rng=np.random.default_rng(1))
    assert got.dtype == torch.complex128 and got.shape == (48,)
    assert np.abs(got.numpy() - _expm_final(A, psi0, tlist)).max() < 1e-11
    assert len(calls) > 0 and len(calls) % (len(tlist) - 1) == 0


def test_dd_static_operator_fold(banded_problem):
    """A static Operator (ops + scalar coeffs) folds host-side and
    propagates through the banded route."""
    A, psi0, tlist = banded_problem
    op1 = qt.bsr_from_scipy(A, block_size=8)
    op2 = qt.bsr_from_scipy(0.5 * A, block_size=8)
    gen = Operator([op1, op2], np.array([0.6, 0.8]))
    psi_final, _ = cheby_propagate_fused(
        torch.as_tensor(psi0), gen, tlist, kernel="dd",
        rng=np.random.default_rng(2),
    )
    want = _expm_final(0.6 * A + 0.8 * (0.5 * A), psi0, tlist)
    assert np.abs(psi_final.numpy() - want).max() < 1e-11


def test_dd_static_nonbanded_falls_back_to_bsr(banded_problem, monkeypatch):
    """Far off-diagonal coupling, same accuracy.  The corner coupling of
    the JAX test still leaves 5 block bands at b = 8, so both packages
    keep the banded route there; a coupling at every block distance
    (11 bands > 9) takes the blocked-ELL product instead."""
    A, psi0, tlist = banded_problem
    A = _nonbanded(A)
    psi_final, _ = cheby_propagate_fused(
        torch.as_tensor(psi0),
        torch.as_tensor(A.toarray(), dtype=torch.complex128), tlist,
        kernel="dd", rng=np.random.default_rng(3),
    )
    assert np.abs(psi_final.numpy() - _expm_final(A, psi0, tlist)).max() < 1e-11
    A = A.tolil()
    for d in range(1, 6):
        A[0, 8 * d] = A[8 * d, 0] = 0.1 * d
    A = A.tocsr()
    calls = _count_spmv(monkeypatch)
    psi_final, _ = cheby_propagate_fused(
        torch.as_tensor(psi0), qt.csr_from_scipy(A), tlist, kernel="dd",
        rng=np.random.default_rng(3),
    )
    assert not calls
    assert np.abs(psi_final.numpy() - _expm_final(A, psi0, tlist)).max() < 1e-11


def test_dd_static_observables_stream(banded_problem):
    """Observables stream through the dd loop on the UNPADDED state
    (N = 45 is padded to 48 inside the banded route)."""
    A, psi0, tlist = banded_problem
    A = A[:45, :45].tocsr()
    psi0 = psi0[:45] / np.linalg.norm(psi0[:45])
    op = qt.bsr_from_scipy(A, block_size=8)
    n_op = torch.as_tensor(np.diag(np.arange(45, dtype=float)))
    store = qt.propagate(
        torch.as_tensor(psi0), op, tlist, method="cheby", fused=True,
        kernel="dd", storage=True, observables=[n_op],
        rng=np.random.default_rng(4),
    )
    assert store.shape == (len(tlist),)
    ref = qt.propagate(
        torch.as_tensor(psi0), op, tlist, method="cheby", storage=True,
        observables=[n_op], rng=np.random.default_rng(4),
    )
    assert np.allclose(np.asarray(store), np.asarray(ref), atol=1e-10)
    states = qt.propagate(torch.as_tensor(psi0), op, tlist, method="cheby",
                          fused=True, kernel="dd", storage=True,
                          rng=np.random.default_rng(4))
    assert states.shape == (45, len(tlist))
    assert np.abs(states[:, -1] - _expm_final(A, psi0, tlist)).max() < 1e-11


def _jax_generators(A):
    ja = jops.bsr_from_scipy(A, block_size=8)
    return {
        "banded": ja,
        "operator_fold": JOperator(
            [ja, jops.bsr_from_scipy(0.5 * A, block_size=8)],
            jnp.asarray([0.6, 0.8]),
        ),
        "nonbanded": jnp.asarray(_nonbanded(A).toarray(),
                                 dtype=jnp.complex128),
    }


@pytest.mark.parametrize("route", ["banded", "operator_fold", "nonbanded"])
def test_dd_static_matches_jax(banded_problem, route):
    """The port and the JAX package on the same generator, state and
    workspace (two steps each way, observables streamed)."""
    A, psi0, tlist = banded_problem
    jgen = _jax_generators(A)[route]
    bound = float(np.abs(A).sum(axis=1).max()) + 0.4
    args = (2.2 * bound, -1.05 * bound, float(tlist[1] - tlist[0]))
    tl = tlist[:3]
    n_op = np.diag(np.arange(48, dtype=float))
    want, want_obs = jax_fused(
        jnp.asarray(psi0), jgen, tl, workspace=JWorkspace.create(*args),
        kernel="dd", observable_fn=lambda p: jnp.vdot(p, n_op @ p).real,
    )
    n_t = torch.as_tensor(n_op)
    got, got_obs = cheby_propagate_fused(
        torch.as_tensor(psi0), from_jax(jgen), tl,
        workspace=ChebyWorkspace.create(*args), kernel="dd",
        observable_fn=lambda p: torch.vdot(p, n_t.to(p.dtype) @ p).real,
    )
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-12
    assert np.abs(got_obs.numpy() - np.asarray(want_obs)).max() < 1e-11
    back, _ = cheby_propagate_fused(
        got, from_jax(jgen), tl, workspace=ChebyWorkspace.create(*args),
        kernel="dd", backward=True,
    )
    assert np.abs(back.numpy() - psi0).max() < 1e-12


def test_dd_static_device_route_planes_bit_equal_to_scipy_route(
        banded_problem):
    """The BSROperator route builds the band planes on the operator's
    own device; they equal the host scipy route's bit for bit, and the
    blocked-ELL padding blocks (all zero, pointing at block-column 0)
    add no spurious offset −r."""
    A, psi0, tlist = banded_problem
    A = A.tolil()
    A[8, 40] = 0.25  # block-row 1 gets a fourth block: the others pad
    A = A.tocsr()
    op = qt.bsr_from_scipy(A, block_size=8)
    assert op.blocks.shape[1] == 4 and int(op.cols[-1, -1]) == 0
    dev = bsr_dd.banded_dd_from_bsr(op)
    ref = bsr_dd.banded_dd_from_scipy(to_scipy_sparse(op),
                                      block=8)
    assert dev.offsets == ref.offsets == (-1, 0, 1, 4)
    assert torch.equal(dev.planes, ref.planes)
    assert (dev.R, dev.b, dev.shape) == (ref.R, ref.b, ref.shape)
    # and the whole path agrees whichever route built the planes
    ws = ChebyWorkspace.create(14.0, -6.5, 0.05)
    via_bsr, _ = cheby_propagate_fused(torch.as_tensor(psi0), op, tlist,
                                       workspace=ws, kernel="dd")
    via_csr, _ = cheby_propagate_fused(torch.as_tensor(psi0),
                                       qt.csr_from_scipy(A), tlist,
                                       workspace=ws, kernel="dd")
    assert torch.equal(via_bsr, via_csr)


def test_dd_static_rejects_complex_and_time_dependent(banded_problem):
    A, psi0, tlist = banded_problem
    ws = ChebyWorkspace.create(14.0, -6.5, 0.05)
    psi = torch.as_tensor(psi0)
    with pytest.raises(ValueError, match="real operator entries"):
        cheby_propagate_fused(psi, qt.bsr_from_scipy(1j * A, block_size=8),
                              tlist, workspace=ws, kernel="dd")
    with pytest.raises(ValueError, match="real operator entries"):
        cheby_propagate_fused(psi, qt.csr_from_scipy(1j * A), tlist,
                              workspace=ws, kernel="dd")
    gen = qt.hamiltonian(qt.csr_from_scipy(A),
                         (qt.csr_from_scipy(A), lambda t: np.sin(t)))
    with pytest.raises(ValueError, match="diagonal-plus-site-flip"):
        cheby_propagate_fused(psi, gen, tlist, workspace=ws, kernel="dd")
