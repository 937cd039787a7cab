"""The PyTorch port imports without jax, nvcc, triton or a GPU, and its
kernel wrappers route CPU tensors to the plain versions."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quantumpropagators_torch.ops import _cuda
from quantumpropagators_torch.ops import cheby_flip as cf

ROOT = Path(__file__).resolve().parents[1]


def test_import_does_not_load_jax():
    code = (
        "import sys, quantumpropagators_torch, "
        "quantumpropagators_torch.fused, "
        "quantumpropagators_torch.ops.fused_cheby_dd, "
        "quantumpropagators_torch.ops.cheby_flip, "
        "quantumpropagators_torch.ops.banded_spmv, "
        "quantumpropagators_torch.ops.bsr_dd, "
        "quantumpropagators_torch.utils.fixtures, "
        "quantumpropagators_torch.ops.planar, "
        "quantumpropagators_torch.native; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert 'triton' not in sys.modules, 'triton imported'"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_kernel_module_imports_without_toolchain(tmp_path):
    """Importing the kernel modules builds nothing and needs no nvcc:
    the build directory is only created by a build."""
    code = (
        "import os, quantumpropagators_torch.ops.cheby_flip as cf, "
        "quantumpropagators_torch.ops._cuda as c; "
        "os.environ['PATH'] = ''; "
        "assert c._lib is None and not c.build_info; "
        "assert set(cf.LAUNCHES) == {'cheby_flip_first<float>', "
        "'cheby_flip_first<double>', 'cheby_flip_iter<float>', "
        "'cheby_flip_iter<double>', 'cheby_flip_high<float>', "
        "'cheby_flip_high<double>'}"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_build_is_keyed_on_source_hash():
    path = _cuda.library_path()
    assert path.parent == _cuda.BUILD_DIR
    assert path.name.startswith("kernels_") and path.suffix == ".so"
    assert {src.name for src in _cuda.SOURCES} >= {"cheby_flip.cu",
                                                   "banded_spmv.cu"}
    assert path == _cuda.library_path()


def _inputs(L, cdtype):
    rdtype = torch.float32 if cdtype == torch.complex64 else torch.float64
    rng = np.random.default_rng(5)
    v = torch.as_tensor(rng.standard_normal(2 ** L)
                        + 1j * rng.standard_normal(2 ** L)).to(cdtype)
    dmb = torch.as_tensor(rng.standard_normal(2 ** L)).to(rdtype)
    G = torch.as_tensor(rng.uniform(0.5, 1.5, L)).to(rdtype)
    return v, dmb, G


@pytest.mark.parametrize("cdtype", [torch.complex64, torch.complex128])
def test_cpu_wrapper_is_plain_and_uncounted(cdtype):
    cf.reset_launches()
    v, dmb, G = _inputs(6, cdtype)
    v1, phi = cf.cheby_flip_first(v, dmb, G, -0.1, 0.7, 0.2)
    w1, wphi = cf.cheby_flip_first_plain(v, dmb, G, -0.1, 0.7, 0.2)
    assert torch.equal(v1, w1) and torch.equal(phi, wphi)
    v0 = v.clone()
    out = cf.cheby_flip_iter(v0, v1, phi, dmb, G, -0.2, 0.3)
    assert out is v0
    assert all(n == 0 for n in cf.LAUNCHES.values())


def test_flip_sum_matches_index_xor():
    L = 7
    v, _, G = _inputs(L, torch.complex128)
    idx = np.arange(2 ** L)
    want = sum(G[j].item() * v.numpy()[idx ^ (1 << j)] for j in range(L))
    got = cf.flip_sum_plain(v, G).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


def test_wrapper_validates_arguments():
    v, dmb, G = _inputs(6, torch.complex128)
    with pytest.raises(ValueError, match="G must be"):
        cf.cheby_flip_first(v, dmb, G[:-1], -0.1, 0.7, 0.2)
    with pytest.raises(ValueError, match="dmb must be"):
        cf.cheby_flip_first(v, dmb.float(), G, -0.1, 0.7, 0.2)
    with pytest.raises(ValueError, match="2\\^L"):
        cf.cheby_flip_first(v[:48], dmb[:48], G, -0.1, 0.7, 0.2)
    with pytest.raises(TypeError, match="complex64 or complex128"):
        cf.cheby_flip_first(v.real, dmb, G, -0.1, 0.7, 0.2)
    with pytest.raises(ValueError, match="L = 31 > 30"):
        cf._check([torch.zeros((), dtype=torch.complex64).expand(2 ** 31)],
                  dmb, G)
