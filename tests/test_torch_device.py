"""The port builds on the card unless the caller asks for the CPU: the
package default device is ``cuda``, every builder resolves
``device=None`` to it, and without a CUDA device that raises instead of
falling back to the CPU."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import quantumpropagators_torch as qt
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch.ops import bsr_dd
from quantumpropagators_torch.ops.operators import as_tensor

# the package builds on the card by default; these tests run on the CPU
qt.set_default_device("cpu")

A = sp.diags([np.ones(15), np.arange(16.0), np.ones(15)], [-1, 0, 1]).tocsr()
BUILDERS = {
    "transverse_field_ising": lambda: qt.transverse_field_ising(4)[0].diag,
    "transverse_field_ising_2d":
        lambda: qt.transverse_field_ising_2d(2, 2)[1].site_mats,
    "csr_from_scipy": lambda: qt.csr_from_scipy(A).data,
    "csr_from_dense": lambda: qt.csr_from_dense(A.toarray()).data,
    "bsr_from_scipy": lambda: qt.bsr_from_scipy(A, block_size=4).blocks,
    "bsr_from_dense": lambda: qt.bsr_from_dense(A.toarray(), 4).blocks,
    "dia_from_scipy": lambda: qt.dia_from_scipy(A).data,
    "banded_dd_from_scipy":
        lambda: bsr_dd.banded_dd_from_scipy(A, block=4).planes,
    "from_jax": lambda: from_jax(np.arange(4.0)),
    "as_tensor": lambda: as_tensor(np.arange(4.0)),
}


@pytest.fixture
def cuda_default():
    qt.set_default_device("cuda")
    try:
        yield
    finally:
        qt.set_default_device("cpu")


def test_default_is_cuda_and_restored():
    qt.set_default_device("cuda")
    try:
        assert qt.default_device() == torch.device("cuda")
    finally:
        qt.set_default_device("cpu")
    assert qt.default_device() == torch.device("cpu")


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_use_default_device(name, cuda_default):
    """With the default ``cuda``: on a machine without a GPU the build
    raises, with one it lands on the card.  With ``cpu`` it lands on the
    CPU, and an explicit device always wins."""
    if torch.cuda.is_available():
        assert BUILDERS[name]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BUILDERS[name]()
    qt.set_default_device("cpu")
    assert BUILDERS[name]().device.type == "cpu"


def test_propagate_numpy_state_uses_default_device(cuda_default):
    """``propagate`` given a numpy state puts it on the default device:
    no silent CPU run."""
    Hd, Hx = qt.transverse_field_ising(3, device="cpu",
                                       dtype=torch.complex128)
    psi = np.zeros(8, dtype=complex)
    psi[0] = 1.0
    tlist = np.linspace(0, 0.2, 3)
    kw = dict(method="cheby", fused=True, kernel="dd",
              specrange_method="manual", E_min=-6.0, E_max=6.0)
    gen = qt.hamiltonian(Hd, Hx)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            qt.propagate(psi, gen, tlist, **kw)
    qt.set_default_device("cpu")
    out = qt.propagate(psi, gen, tlist, **kw)
    assert out.device.type == "cpu"
    assert abs(float(torch.linalg.vector_norm(out)) - 1.0) < 1e-12
