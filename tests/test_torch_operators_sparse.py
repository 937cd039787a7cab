"""Port vs JAX package: the sparse operator types of the static banded
slice (``BSROperator``, ``DIAOperator``, ``StackedCSROperator``), their
builders and ``to_scipy_sparse``; ``apply`` at 1e-13."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from quantumpropagators.models.generators import Operator as JOperator
from quantumpropagators.ops import operators as jops
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.interop import from_jax, to_numpy
from quantumpropagators_torch.models.generators import Operator
from quantumpropagators_torch.ops import operators as tops

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")

TOL = 1e-13


def _banded(N, seed, complex_=False):
    rng = np.random.default_rng(seed)
    offs = [-9, -2, -1, 0, 1, 3, 8]
    diags = [rng.standard_normal(N - abs(o)) for o in offs]
    if complex_:
        diags = [d + 1j * rng.standard_normal(d.shape) for d in diags]
    return sp.diags(diags, offs).tocsr()


def _state(N, seed, batch=()):
    rng = np.random.default_rng(seed)
    shape = batch + (N,)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _pairs():
    """(name, JAX operator, scipy matrix it stands for)."""
    A = _banded(48, 1)
    C = _banded(45, 2, complex_=True)  # 45: not a multiple of the block
    S = sp.random(40, 40, density=0.15, random_state=3, format="csr")
    T = S.copy()
    T.data = np.random.default_rng(4).standard_normal(T.nnz)
    csr = jops.csr_from_scipy(S)
    stacked = jops.StackedCSROperator(
        jnp.stack([csr.data, jnp.asarray(T.data)]), csr.col, csr.row,
        csr.indptr, csr.shape,
    )
    return [
        ("bsr_real_b8", jops.bsr_from_scipy(A, block_size=8), A),
        ("bsr_complex_padded", jops.bsr_from_scipy(C, block_size=4), C),
        ("bsr_auto_block", jops.bsr_from_scipy(A), A),
        ("bsr_from_dense", jops.bsr_from_dense(A.toarray(), block_size=16), A),
        ("dia_real", jops.dia_from_scipy(A), A),
        ("dia_complex", jops.dia_from_scipy(C), C),
        ("stacked_csr", stacked, S + T),
    ]


PAIRS = {name: (op, M) for name, op, M in _pairs()}


@pytest.mark.parametrize("name", sorted(PAIRS))
@pytest.mark.parametrize("batch", [(), (3,)])
def test_apply_matches_jax(name, batch):
    jop, M = PAIRS[name]
    top = from_jax(jop)
    psi = _state(M.shape[0], 7, batch)
    want = np.asarray(jops.apply(jop, jnp.asarray(psi)))
    got = to_numpy(tops.apply(top, torch.as_tensor(psi)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL * max(1.0, np.abs(want).max())
    # and against the matrix it stands for
    ref = (M @ psi.reshape(-1, M.shape[0]).T).T.reshape(psi.shape)
    assert np.abs(got - ref).max() < TOL * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_to_scipy_sparse_matches_jax(name):
    jop, M = PAIRS[name]
    got = tops.to_scipy_sparse(from_jax(jop))
    want = jops.to_scipy_sparse(jop)
    assert got.shape == want.shape == M.shape
    assert abs(got - want).max() == 0.0
    assert abs(got - M).max() < TOL


@pytest.mark.parametrize("N, b", [(48, 8), (45, 4), (64, None)])
def test_bsr_from_scipy_layout_matches_jax(N, b):
    A = _banded(N, 11)
    j = jops.bsr_from_scipy(A, block_size=b)
    t = tops.bsr_from_scipy(A, block_size=b)
    assert t.block_size == j.block_size and t.shape == j.shape
    assert np.array_equal(to_numpy(t.blocks), np.asarray(j.blocks))
    assert np.array_equal(to_numpy(t.cols), np.asarray(j.cols))
    assert t.blocks.dtype == torch.float64 and t.cols.dtype == torch.int64
    assert tops.choose_block_size(N) == jops.choose_block_size(N)


def test_dia_from_scipy_layout_matches_jax():
    C = _banded(45, 12, complex_=True)
    j = jops.dia_from_scipy(C)
    t = tops.dia_from_scipy(C)
    assert t.offsets == j.offsets and t.shape == j.shape
    assert np.array_equal(to_numpy(t.data), np.asarray(j.data))
    assert np.abs(to_numpy(tops.to_dense(t)) - C.toarray()).max() == 0.0


def test_stacked_csr_coefficients_match_jax():
    jop, _ = PAIRS["stacked_csr"]
    top = from_jax(jop)
    psi = _state(40, 13)
    c = np.array([0.3, -1.7])
    want = np.asarray(jop.apply(jnp.asarray(psi), jnp.asarray(c)))
    got = to_numpy(top.apply(torch.as_tensor(psi), c))
    assert np.abs(got - want).max() < TOL
    assert np.abs(to_numpy(top.to_dense(c))
                  - np.asarray(jop.to_dense(jnp.asarray(c)))).max() < TOL


def test_bsr_in_operator_sum_scale_and_add():
    """BSR terms inside a lazy Operator sum, and the host-side
    structural scale/add, agree with the JAX package."""
    A, B = _banded(48, 21), _banded(48, 22)
    ja, jb = (jops.bsr_from_scipy(M, block_size=8) for M in (A, B))
    ta, tb = from_jax(ja), from_jax(jb)
    psi = _state(48, 23)
    jsum = JOperator([ja, jb], jnp.asarray([0.4]))
    tsum = Operator([ta, tb], np.array([0.4]))
    want = np.asarray(jsum.apply(jnp.asarray(psi)))
    got = to_numpy(tsum.apply(torch.as_tensor(psi)))
    assert np.abs(got - want).max() < TOL
    added = tops.add_operators(ta, tb)
    assert isinstance(added, tops.BSROperator) and added.block_size == 8
    assert abs(tops.to_scipy_sparse(added) - (A + B)).max() < TOL
    scaled = tops.scale_operator(-2.5, ta)
    assert abs(tops.to_scipy_sparse(scaled) - (-2.5 * A)).max() < TOL
