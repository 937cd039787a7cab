"""Port vs JAX package: the host assembly library (every case of
``test_native.py``, L = 6 and 2 × 3).  Both packages compile the same
C++ source, so the port's arrays must equal the JAX module's bit for
bit; against scipy the JAX test's 1e-12 holds."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import scipy.sparse as sp

import quantumpropagators.native as jnative
from quantumpropagators.utils.fixtures import random_state_vector
from quantumpropagators_torch import native, set_default_device
from quantumpropagators_torch.models.lattice import PAULI

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")


def _site(op, i, L):
    out = sp.identity(1, format="csr", dtype=complex)
    for j in range(L):
        out = sp.kron(out, op if j == i else sp.identity(2, format="csr"),
                      format="csr")
    return out


def _assert_same_arrays(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_native_builds():
    assert native.native_available(), "native library failed to build"
    assert native.library_path().exists()
    assert native.library_path().parent == native.BUILD_DIR
    assert jnative.native_available()


@pytest.mark.parametrize("periodic", [False, True])
def test_chain_assembly_matches_scipy_and_jax(periodic):
    L, J, g, h = 6, 0.8, 1.1, -0.2
    got = native.tfim_chain_csr(L, J, g, h, periodic)
    _assert_same_arrays(got, jnative.tfim_chain_csr(L, J, g, h, periodic))
    indptr, cols, vals = got
    A = sp.csr_matrix((vals, cols, indptr), shape=(2 ** L, 2 ** L))
    X, Z = sp.csr_matrix(PAULI["X"]), sp.csr_matrix(PAULI["Z"])
    B = sp.csr_matrix((2 ** L, 2 ** L), dtype=complex)
    bonds = [(i, i + 1) for i in range(L - 1)] + (
        [(L - 1, 0)] if periodic else [])
    for i, j in bonds:
        B = B + J * (_site(Z, i, L) @ _site(Z, j, L))
    for i in range(L):
        B = B + h * _site(Z, i, L) + g * _site(X, i, L)
    assert abs(A - B).max() < 1e-12


def test_lattice2d_assembly_matches_scipy_and_jax():
    Lx, Ly, J, g, h = 2, 3, 0.8, 1.1, -0.2
    got = native.tfim_lattice2d_csr(Lx, Ly, J, g, h)
    _assert_same_arrays(got, jnative.tfim_lattice2d_csr(Lx, Ly, J, g, h))
    indptr, cols, vals = got
    L = Lx * Ly
    A = sp.csr_matrix((vals, cols, indptr), shape=(2 ** L, 2 ** L))
    X, Z = sp.csr_matrix(PAULI["X"]), sp.csr_matrix(PAULI["Z"])
    B = sp.csr_matrix((2 ** L, 2 ** L), dtype=complex)
    for x in range(Lx):
        for y in range(Ly):
            s = x * Ly + y
            B = B + h * _site(Z, s, L) + g * _site(X, s, L)
            if x + 1 < Lx:
                B = B + J * _site(Z, s, L) @ _site(Z, (x + 1) * Ly + y, L)
            if y + 1 < Ly:
                B = B + J * _site(Z, s, L) @ _site(Z, x * Ly + y + 1, L)
    assert abs(A - B).max() < 1e-12


def test_native_spmv():
    rng = np.random.default_rng(5)
    L = 10
    indptr, cols, vals = native.tfim_chain_csr(L, 1.0, 1.3, 0.2)
    x = random_state_vector(2 ** L, rng=rng)
    y = native.csr_spmv(indptr, cols, vals, x)
    A = sp.csr_matrix((vals, cols, indptr), shape=(2 ** L, 2 ** L))
    assert np.allclose(y, A @ x, atol=1e-12)
    assert np.array_equal(y, jnative.csr_spmv(indptr, cols, vals, x))


def test_band_partition_remap_matches_python():
    indptr, cols, _ = native.tfim_chain_csr(8, 1.0, 1.0, 0.1)
    # the top-bit flip reaches 128 rows, more than a 64-row block
    assert native.band_partition_remap(indptr, cols, 4) == (None, None)
    assert native._band_partition_remap_np(indptr, cols, 4) == (None, None)
    N = 256
    A = sp.diags(
        [np.ones(N - 3), np.ones(N), np.ones(N - 3)], [-3, 0, 3], format="csr"
    )
    w, ext = native.band_partition_remap(A.indptr, A.indices, 8)
    assert w == 3
    n_local = N // 8
    row = np.repeat(np.arange(N), np.diff(A.indptr))
    lo = (row // n_local) * n_local
    assert np.array_equal(ext, A.indices - (lo - w))
    jw, jext = jnative.band_partition_remap(A.indptr, A.indices, 8)
    nw, next_ = native._band_partition_remap_np(A.indptr, A.indices, 8)
    assert w == jw == nw
    assert np.array_equal(ext, jext) and np.array_equal(ext, next_)


def test_fresh_build_dir_concurrent(tmp_path, monkeypatch):
    """Three threads build the library at once into an empty build
    directory (each runs its own g++): one whole library is left, no
    temporary directory stays, and it gives the JAX module's values."""
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    with ThreadPoolExecutor(3) as pool:
        paths = [f.result() for f in [pool.submit(native.build)
                                      for _ in range(3)]]
    assert paths == [build_dir / native.library_path().name] * 3
    assert [p.name for p in build_dir.iterdir()] == [paths[0].name]
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    got = native.tfim_chain_csr(6, 0.8, 1.1, -0.2)
    assert native._LIB is not None
    _assert_same_arrays(got, jnative.tfim_chain_csr(6, 0.8, 1.1, -0.2))


def test_paths_without_compiler(tmp_path, monkeypatch):
    """Without ``g++`` the scipy/numpy paths run and give the library's
    results (1e-12); the 2D assembly raises."""
    indptr, cols, vals = native.tfim_chain_csr(6, 0.8, 1.1, -0.2, True)
    x = np.arange(64.0) + 1j
    want_A = sp.csr_matrix((vals, cols, indptr)).toarray()
    want_y = native.csr_spmv(indptr, cols, vals, x)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setenv("PATH", "")
    assert not native.native_available()
    assert not list(tmp_path.glob("_build/**/*.so"))
    indptr, cols, vals = native.tfim_chain_csr(6, 0.8, 1.1, -0.2, True)
    A = sp.csr_matrix((vals, cols, indptr)).toarray()
    assert np.abs(A - want_A).max() < 1e-12
    np.testing.assert_allclose(native.csr_spmv(indptr, cols, vals, x),
                               want_y, atol=1e-12, rtol=0)
    N = 256
    B = sp.diags([np.ones(N - 3), np.ones(N)], [-3, 0], format="csr")
    w, ext = native.band_partition_remap(B.indptr, B.indices, 8)
    w_np, ext_np = native._band_partition_remap_np(B.indptr, B.indices, 8)
    assert w == w_np == 3 and np.array_equal(ext, ext_np)
    with pytest.raises(RuntimeError, match="native library"):
        native.tfim_lattice2d_csr(2, 3)
