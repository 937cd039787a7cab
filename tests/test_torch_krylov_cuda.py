"""The Krylov layer on the card against the same calls on CPU tensors:
``apply_cdd_op`` over banded terms, fixed-Leja Newton propagation and
the flip-structured ``cheby_apply_dd``, each ≤ 1e-12, with the banded
kernel's launch count.  Needs an NVIDIA GPU with nvcc (``-m cuda``);
skips without one.  Imports no jax: run with ``--noconftest``."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import quantumpropagators_torch as qt
from quantumpropagators_torch.ops import banded_spmv as bs
from quantumpropagators_torch.ops import cheby_flip as cf
from quantumpropagators_torch.ops.bsr_dd import banded_dd_from_scipy
from quantumpropagators_torch.ops.cheby import cheby_coeffs
from quantumpropagators_torch.ops.dd_linalg import CDDOp, TermsDDOp, apply_cdd_op
from quantumpropagators_torch.ops.df64 import cheby_apply_dd
from quantumpropagators_torch.ops.newton_leja import newton_leja_propagate_dd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _banded(N, seed, offsets=(-200, -1, 0, 1, 130)):
    rng = np.random.default_rng(seed)
    diags = [rng.normal(size=N - abs(k)) for k in offsets]
    A = sp.diags(diags, offsets).tocsr()
    return (0.5 * (A + A.T)).tocsr()


def _state(N, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=N) + 1j * rng.normal(size=N)
    return v / np.linalg.norm(v)


def test_terms_op_two_banded_terms_on_card(cuda):
    N = 128 * 24
    terms = {}
    for dev in (cuda, torch.device("cpu")):
        terms[dev.type] = tuple(
            CDDOp(banded_dd_from_scipy(_banded(N, s), device=dev), None,
                  (N, N)) for s in (1, 2))
    coeffs = np.array([0.7 - 0.2j])
    v = _state(N, 3)
    want = apply_cdd_op(TermsDDOp(terms["cpu"], coeffs),
                        torch.as_tensor(v)).numpy()
    bs.reset_launches()
    got = apply_cdd_op(TermsDDOp(terms["cuda"], coeffs),
                       torch.as_tensor(v, device=cuda))
    torch.cuda.synchronize()
    assert bs.LAUNCHES["banded_spmv<double>"] == 2
    assert np.abs(got.cpu().numpy() - want).max() <= 1e-12 * np.abs(
        want).max()


def test_newton_leja_on_card_matches_cpu(cuda):
    """2^14 states, a static banded operator of 128-blocks, 6 steps: every
    Leja node is one banded kernel launch on the card."""
    N = 2 ** 14
    A = _banded(N, 4)
    bound = float(abs(A).sum(axis=1).max())  # Gershgorin
    e_min, e_max = -bound, bound
    tlist = np.linspace(0.0, 6 * 0.4, 7)
    psi0 = _state(N, 5)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        op = qt.bsr_from_scipy(A, block_size=128, device=dev)
        bs.reset_launches()
        psi, _, plan = newton_leja_propagate_dd(
            torch.as_tensor(psi0, device=dev), op, tlist, e_min=e_min,
            e_max=e_max)
        out[dev.type] = psi.cpu().numpy()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert bs.LAUNCHES["banded_spmv<double>"] == 6 * (
                len(plan.points) - 1)
    assert np.abs(out["cuda"] - out["cpu"]).max() <= 1e-12


def test_cheby_apply_dd_on_card_matches_cpu(cuda):
    """One flip-structured step at L = 20 runs every order on the double
    flip kernels."""
    L = 20
    rng = np.random.default_rng(6)
    diag = rng.normal(size=2 ** L)
    gs = rng.uniform(0.5, 1.5, L)
    bound = np.abs(diag).max() + gs.sum()  # |spec| <= bound
    delta, e_min, dt = 2.0 * bound + 0.6, -bound - 0.3, 0.05
    coeffs = cheby_coeffs(delta, dt)
    psi0 = _state(2 ** L, 7)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        cf.reset_launches()
        psi = cheby_apply_dd(torch.as_tensor(psi0, device=dev),
                             torch.as_tensor(diag, device=dev), gs, coeffs,
                             delta, e_min, dt, L=L)
        out[dev.type] = psi.cpu().numpy()
        if dev.type == "cuda":
            assert cf.LAUNCHES["cheby_flip_first<double>"] == 1
            assert cf.LAUNCHES["cheby_flip_iter<double>"] == len(coeffs) - 2
    assert np.abs(out["cuda"] - out["cpu"]).max() <= 1e-12
