"""Port vs JAX package: parameterized controls and parameter aliasing
(every case of ``test_parameterization.py``; reference
``test/test_parameterization.jl``).  The collected arrays alias the
controls' own parameters in both packages, and propagations with the
current values agree to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumpropagators as qp
import quantumpropagators.interfaces  # noqa: F401  (qp.interfaces below)
import quantumpropagators_torch as qt
from quantumpropagators_torch import set_default_device

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")

SX = np.array([[0, 1], [1, 0]], dtype=complex)
SY = np.array([[0, -1j], [1j, 0]])
PACKAGES = [(qt, torch.as_tensor), (qp, jnp.asarray)]


def _cosine_class(pkg):
    class CosineControl(pkg.ParameterizedFunction):
        """f(t) = p[0] * cos(p[1] * t)"""

        def __init__(self, a, w):
            self.parameters = np.array([a, w], dtype=np.float64)

        def __call__(self, t):
            return float(self.parameters[0] * np.cos(self.parameters[1] * t))

    return CosineControl


def test_parameters_alias():
    tlist = np.linspace(0, 1, 11)
    for pkg, _ in PACKAGES:
        f = _cosine_class(pkg)(1.0, 2.0)
        p = pkg.get_parameters(f)
        assert p is f.parameters
        p[0] = 5.0  # mutating the collected array mutates the control
        assert f(0.0) == pytest.approx(5.0)
        assert pkg.interfaces.check_parameterized_function(f, tlist=tlist)
        assert pkg.interfaces.check_parameterized(f)


def test_generator_parameter_collection():
    for pkg, arr in PACKAGES:
        C = _cosine_class(pkg)
        f1, f2 = C(1.0, 2.0), C(0.5, 3.0)
        gen = pkg.hamiltonian(arr(np.zeros((2, 2), dtype=complex)),
                              (arr(SX), f1), (arr(SY), f2))
        params = pkg.get_parameters(gen)
        assert isinstance(params, tuple)
        assert len(params) == 2
        assert params[0] is f1.parameters
        assert params[1] is f2.parameters


def test_shared_vs_independent_parameters():
    """Enantiomer setup (reference test_parameterization.jl:226-297):
    two generators driven by controls that share one parameter array;
    it is collected once across both generators, and mutating it
    affects both."""
    for pkg, arr in PACKAGES:
        shared = np.array([1.0, 2.0])

        class SharedControl(pkg.ParameterizedFunction):
            def __init__(self, parameters, sign):
                self.parameters = parameters  # aliased, not copied
                self.sign = sign

            def __call__(self, t):
                return float(self.sign * self.parameters[0]
                             * np.cos(self.parameters[1] * t))

        plus, minus = SharedControl(shared, +1.0), SharedControl(shared, -1.0)
        zero = arr(np.zeros((2, 2), dtype=complex))
        gens = (pkg.hamiltonian(zero, (arr(SX), plus)),
                pkg.hamiltonian(zero, (arr(SX), minus)))
        all_params = []
        for g in gens:
            p = pkg.get_parameters(g)
            for a in (p if isinstance(p, tuple) else (p,)):
                if not any(a is s for s in all_params):
                    all_params.append(a)
        assert len(all_params) == 1 and all_params[0] is shared
        shared[0] = 3.0
        assert plus(0.0) == pytest.approx(3.0)
        assert minus(0.0) == pytest.approx(-3.0)


def test_parameterized_control_in_propagation():
    """Propagation picks up the current parameter values at init; both
    packages give the same states (1e-12) and the JAX test's
    populations (1e-9)."""
    tlist = np.linspace(0, np.pi / 2, 51)
    outs = []
    for pkg, arr in PACKAGES:
        f = _cosine_class(pkg)(1.0, 0.0)  # constant amplitude p[0]
        gen = pkg.hamiltonian(arr(np.zeros((2, 2), dtype=complex)),
                              (arr(SX), f))
        psi0 = arr(np.array([1, 0], dtype=complex))
        out = np.asarray(pkg.propagate(psi0, gen, tlist, method="cheby"))
        assert abs(abs(out[1]) ** 2 - 1.0) < 1e-9
        f.parameters[0] = 0.5
        out2 = np.asarray(pkg.propagate(psi0, gen, tlist, method="cheby"))
        assert abs(out2[1]) ** 2 == pytest.approx(0.5, abs=1e-9)
        outs.append((out, out2))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)


def test_parameter_partition_combined_view():
    """Multiple parameter arrays combine into a flat aliased view
    (reference ArrayPartition combining, src/controls.jl:575-621)."""
    for pkg, arr in PACKAGES:
        C = _cosine_class(pkg)
        f1, f2 = C(1.0, 2.0), C(0.5, 3.0)
        gen = pkg.hamiltonian(arr(np.zeros((2, 2), dtype=complex)),
                              (arr(SX), f1), (arr(SY), f2))
        p = pkg.get_parameters(gen)
        assert isinstance(p, pkg.ParameterPartition)
        assert isinstance(p, tuple)
        assert p.n_params == 4
        v = p.as_vector()
        assert v.shape == (4,)
        assert np.allclose(v, [1.0, 2.0, 0.5, 3.0])
        p.set_vector(np.array([9.0, 8.0, 7.0, 6.0]))
        assert f1.parameters[0] == 9.0 and f1.parameters[1] == 8.0
        assert f2.parameters[0] == 7.0 and f2.parameters[1] == 6.0
        assert float(f1(0.0)) == 9.0
        with pytest.raises(ValueError):
            p.set_vector(np.zeros(3))
        assert p.flat_index(2) == (1, 0)
