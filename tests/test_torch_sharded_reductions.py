"""Port vs JAX package: the Krylov methods on a sharded state (mirrors
``test_sharded_reductions.py``, ``test_sharded_chain.py``'s
``test_gspmd_sharded_newton`` and ``test_sharded_bsr.py``'s
``test_distributed_bsr_newton``) on 8 shard slots in one process.

In the JAX package a plain ``Operator`` meets a GSPMD-sharded state and
XLA inserts the reductions; in the port the operator carries the mesh
(``ShardedChainOperator``, ``DistributedBSR``) and the reductions sum
per-slot partial sums over ``Mesh.psum``.  Each test runs the JAX
package's own sharded call on its 8-device mesh and the port's on the
same inputs, holds them against each other (and against ``expm``) at
the JAX tests' tolerances, and checks that the port's results stay in
the ``(n_local, N/n)`` layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.models.lattice import transverse_field_ising
from quantumpropagators.ops.arnoldi import arnoldi as jax_arnoldi
from quantumpropagators.ops.expv import expv_apply as jax_expv
from quantumpropagators.ops.newton import newton_apply as jax_newton
from quantumpropagators.ops.specrange import ritzvals as jax_ritzvals
from quantumpropagators.ops.specrange import specrange as jax_specrange
from quantumpropagators.parallel import mesh as jax_mesh
from quantumpropagators.parallel import sharded_bsr as jax_sbsr
from quantumpropagators.utils.fixtures import random_state_vector
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch.ops.arnoldi import arnoldi
from quantumpropagators_torch.ops.expv import expv_apply
from quantumpropagators_torch.ops.newton import newton_apply
from quantumpropagators_torch.ops.operators import op_mesh, sharded_dim
from quantumpropagators_torch.ops.specrange import (random_state, ritzvals,
                                                    specrange)
from quantumpropagators_torch.parallel import (DistributedBSR, chain_mesh,
                                               partition_bsr,
                                               shard_chain_operator,
                                               shard_vector)

qt.set_default_device("cpu")

SLOTS = 8


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < SLOTS:
        pytest.skip("needs 8 (virtual) JAX devices")
    return jax_mesh.chain_mesh(SLOTS), chain_mesh(SLOTS, device="cpu")


def _chain(L, seed, group_bits):
    """The JAX tests' TFIM chain: the JAX operator with its site term
    grouped, the port's as a ShardedChainOperator-ready Operator, the
    dense matrix and a seeded state."""
    H_diag, H_x = transverse_field_ising(L, J=1.0, g=1.2, h=0.3,
                                         dtype=jnp.complex128)
    jop = qp.Operator([H_diag, H_x.grouped(group_bits)], np.array([1.0]))
    top = qt.Operator([from_jax(H_diag), from_jax(H_x)], np.array([1.0]))
    psi = random_state_vector(2 ** L, rng=np.random.default_rng(seed))
    return jop, top, np.asarray(qp.ops.operators.to_dense(jop)), psi


@pytest.fixture(scope="module")
def problem(meshes):
    """``test_sharded_reductions.py``'s problem: L = 9, 8 slots."""
    jm, m = meshes
    jop, top, dense, psi = _chain(9, 23, 3)
    sop = shard_chain_operator(top, m, group_bits=3)
    return dict(jop=jop, top=top, sop=sop, dense=dense, psi=psi,
                jpsi=jax_mesh.shard_vector(jm, jnp.asarray(psi)),
                tpsi=shard_vector(m, psi), mesh=m)


def _flat(x):
    return np.asarray(x.reshape(-1) if isinstance(x, torch.Tensor) else x)


def _layout(x, mesh, N):
    assert tuple(x.shape) == (mesh.n_local, N // mesh.n_devices)


def test_sharded_arnoldi_matches_jax(problem):
    Hj, _qj, mj = jax_arnoldi(problem["jop"], problem["jpsi"], 12, 0.1,
                              extended=True)
    Ht, qt_, mt = arnoldi(problem["sop"], problem["tpsi"], 12, 0.1,
                          extended=True)
    assert mt == mj
    assert np.abs(Ht - np.asarray(Hj)).max() <= 1e-12
    # the basis keeps the state's slot layout
    assert tuple(qt_.shape) == (13, SLOTS, 512 // SLOTS)


def test_sharded_specrange_matches_jax(problem):
    lo_j, hi_j = jax_specrange(problem["jop"], method="arnoldi",
                               state=problem["jpsi"])
    lo, hi = specrange(problem["sop"], method="arnoldi",
                       state=problem["tpsi"])
    assert abs(lo - lo_j) <= 1e-12 and abs(hi - hi_j) <= 1e-12


def test_sharded_ritzvals_match_jax(problem):
    want = np.sort_complex(np.asarray(jax_ritzvals(problem["jop"],
                                                   problem["jpsi"], 10, 20)))
    got = np.sort_complex(ritzvals(problem["sop"], problem["tpsi"], 10, 20))
    assert np.abs(got - want).max() <= 1e-11


def test_sharded_expv_matches_jax(problem):
    dt = 0.2
    exact = scipy.linalg.expm(-1j * problem["dense"] * dt) @ problem["psi"]
    want = jax_expv(problem["jop"], problem["jpsi"], dt, m=40)
    got = expv_apply(problem["sop"], problem["tpsi"], dt, m=40)
    _layout(got, problem["mesh"], 512)
    assert np.linalg.norm(_flat(got) - exact) < 1e-12
    assert np.linalg.norm(_flat(got) - np.asarray(want)) < 1e-12


@pytest.mark.parametrize("backward", [False, True])
def test_sharded_newton_matches_jax(problem, backward):
    dt = -0.15 if backward else 0.15
    exact = scipy.linalg.expm(-1j * problem["dense"] * dt) @ problem["psi"]
    want = jax_newton(problem["jop"], problem["jpsi"], dt, m_max=30)
    got = newton_apply(problem["sop"], problem["tpsi"], dt, m_max=30)
    _layout(got, problem["mesh"], 512)
    assert np.linalg.norm(_flat(got) - exact) < 1e-12
    assert np.linalg.norm(_flat(got) - np.asarray(want)) < 1e-12


def test_sharded_propagate_newton_roundtrip(problem):
    """propagate(method="newton") forward and backward on the sharded
    state: the round trip inverts to 1e-12, the forward result equals
    the JAX package's, and both stay in the slot layout."""
    tlist = np.linspace(0, 1.0, 11)
    jfwd = qp.propagate(problem["jpsi"], qp.hamiltonian(problem["jop"]),
                        tlist, method="newton", m_max=30)
    gen = qt.hamiltonian(problem["sop"])
    fwd = qt.propagate(problem["tpsi"], gen, tlist, method="newton",
                       m_max=30)
    back = qt.propagate(fwd, gen, tlist, method="newton", m_max=30,
                        backward=True)
    _layout(fwd, problem["mesh"], 512)
    _layout(back, problem["mesh"], 512)
    assert np.linalg.norm(_flat(back) - problem["psi"]) < 1e-12
    assert np.linalg.norm(_flat(fwd) - np.asarray(jfwd)) < 1e-12


def test_sharded_newton_propagator_contract(problem, caplog):
    """check_propagator holds for a 3-point sharded Newton propagator,
    forward and backward, with nothing logged."""
    import logging

    gen = qt.hamiltonian(problem["sop"])
    with caplog.at_level(logging.ERROR,
                         logger="quantumpropagators_torch.interfaces"):
        for backward in (False, True):
            prop = qt.init_prop(problem["tpsi"], gen, np.linspace(0, 0.2, 3),
                                method="newton", backward=backward)
            assert qt.check_propagator(prop)
    assert not caplog.records


def test_sharded_dd_and_auto_paths(problem):
    """precision="dd" reaches the sharded operator through the dd layer
    (three steps against the native ones), and method="auto" shards its
    hermiticity probe (which tells an anti-Hermitian sharded operator
    apart) and specrange's start vector: Chebyshev on the sharded state
    equals Chebyshev on the whole one."""
    from quantumpropagators_torch.propagators.base import _looks_hermitian

    tlist = np.linspace(0, 0.3, 4)
    gen = qt.hamiltonian(problem["sop"])
    nat = qt.propagate(problem["tpsi"], gen, tlist, method="newton")
    dd = qt.propagate(problem["tpsi"], gen, tlist, method="newton",
                      precision="dd")
    _layout(dd, problem["mesh"], 512)
    assert float((dd - nat).abs().max()) <= 1e-12
    whole = qt.propagate(torch.as_tensor(problem["psi"]),
                         qt.hamiltonian(problem["top"]), tlist,
                         method="cheby", rng=np.random.default_rng(1))
    x = problem["tpsi"]
    assert _looks_hermitian(problem["sop"], x, tlist)
    assert not _looks_hermitian(qt.Operator([problem["sop"]], [1j]), x, tlist)
    auto = qt.propagate(x, gen, tlist, method="auto",
                        rng=np.random.default_rng(1))
    _layout(auto, problem["mesh"], 512)
    assert np.abs(_flat(auto) - _flat(whole)).max() <= 1e-12


def test_gspmd_sharded_newton(meshes):
    """``test_sharded_chain.py:test_gspmd_sharded_newton``: L = 10, the
    site term grouped by 4 bits, Newton to 1e-10 against expm and the
    JAX package's sharded call."""
    jm, m = meshes
    jop, top, dense, psi = _chain(10, 17, 4)
    dt = 0.15
    exact = scipy.linalg.expm(-1j * dense * dt) @ psi
    want = jax_newton(jop, jax_mesh.shard_vector(jm, jnp.asarray(psi)), dt,
                      m_max=30)
    got = newton_apply(shard_chain_operator(top, m, group_bits=4),
                       shard_vector(m, psi), dt, m_max=30)
    _layout(got, m, 1024)
    assert np.linalg.norm(_flat(got) - exact) < 1e-10
    assert np.linalg.norm(_flat(got) - np.asarray(want)) < 1e-10


def _block_tridiag(R, b, rng):
    """``test_sharded_bsr.py:block_tridiag`` (complex)."""
    import scipy.sparse as sp

    blocks, rows, cols = [], [], []
    for r in range(R):
        for c in (r - 1, r, r + 1):
            if 0 <= c < R:
                rows.append(r)
                cols.append(c)
                blocks.append(rng.normal(size=(b, b))
                              + 1j * rng.normal(size=(b, b)))
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=R))]).astype(np.int64)
    return sp.bsr_matrix((np.asarray(blocks), np.asarray(cols), indptr),
                         shape=(R * b, R * b)).tocsr()


def test_distributed_bsr_newton(meshes):
    """``test_sharded_bsr.py:test_distributed_bsr_newton``: Newton
    through DistributedBSR on 8 slots (R = 16 block rows of b = 4), to
    1e-12 against expm and the JAX class; the JAX class carried through
    ``from_jax`` applies the same."""
    jm, m = meshes
    rng = np.random.default_rng(12)
    A = _block_tridiag(16, 4, rng)
    A = 0.5 * (A + A.conj().T)
    psi = rng.normal(size=64) + 1j * rng.normal(size=64)
    psi /= np.linalg.norm(psi)
    dt = 0.15
    jop = jax_sbsr.DistributedBSR(jm, jax_sbsr.partition_bsr(A, 8,
                                                             block_size=4))
    want = jax_newton(jop, jax_mesh.shard_vector(jm, jnp.asarray(psi)), dt,
                      m_max=24)
    op = DistributedBSR(m, partition_bsr(A, 8, block_size=4, device="cpu"))
    assert op.pbsr.halo_blocks == 1 and op.shape == (64, 64)
    got = newton_apply(op, shard_vector(m, psi), dt, m_max=24)
    exact = scipy.linalg.expm(-1j * A.toarray() * dt) @ psi
    _layout(got, m, 64)
    assert np.linalg.norm(_flat(got) - exact) < 1e-12
    assert np.linalg.norm(_flat(got) - np.asarray(want)) < 1e-12
    carried = from_jax(jop, "cpu", mesh=m)
    x = shard_vector(m, psi)
    assert torch.equal(carried.apply(x), op.apply(x))
    with pytest.raises(ValueError, match="mesh"):
        from_jax(jop, "cpu")


def test_plain_operator_rejects_sharded_state(problem):
    """A plain operator never computes on a sharded state: every Krylov
    entry point raises a ValueError that names the wrappers."""
    plain = problem["top"]
    x = problem["tpsi"]
    for call in (lambda: arnoldi(plain, x, 5),
                 lambda: newton_apply(plain, x, 0.1),
                 lambda: expv_apply(plain, x, 0.1),
                 lambda: ritzvals(plain, x, 5, 10),
                 lambda: qt.propagate(x, qt.hamiltonian(plain),
                                      np.linspace(0, 0.1, 2),
                                      method="newton", check=False)):
        with pytest.raises(ValueError, match="DistributedBSR"):
            call()


def test_op_mesh_and_sharded_random_state(problem):
    m = problem["mesh"]
    sop = problem["sop"]
    assert op_mesh(qt.Operator([sop], [2.0])) is m
    assert op_mesh(problem["top"]) is None
    other = shard_chain_operator(problem["top"],
                                 chain_mesh(SLOTS, device="cpu"))
    with pytest.raises(ValueError, match="two different meshes"):
        op_mesh(qt.Operator([sop, other], [1.0]))
    assert sharded_dim(sop, problem["tpsi"]) == (512, m)
    with pytest.raises(ValueError, match="slots"):
        sharded_dim(sop, torch.zeros(4, 64, dtype=torch.complex128))
    # the same seeded host vector as the unsharded run, sharded
    x = random_state(sop, rng=np.random.default_rng(5))
    y = random_state(problem["top"], rng=np.random.default_rng(5))
    assert torch.equal(x, shard_vector(m, y))
