"""Port vs JAX package: controls, pulse shapes, the ``hamiltonian``
constructor and coefficient tables, on the inputs of ``test_controls.py``,
``test_discretization.py`` and ``test_shapes.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.models.generators import coeff_table_np as jax_table
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch.models.generators import coeff_table_np
from quantumpropagators_torch import set_default_device

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")

TLIST = np.linspace(0, 10, 21)


@pytest.mark.parametrize(
    "name, args, kwargs",
    [
        ("get_tlist_midpoints", (np.linspace(0, 10, 11),), {}),
        ("get_tlist_midpoints", (np.linspace(0, 10, 11),),
         dict(preserve_start=False, preserve_end=False)),
        ("discretize", (np.sin, np.linspace(0, 10, 21)),
         dict(via_midpoints=False)),
        ("discretize", (np.cos, np.linspace(0, np.pi, 40)), {}),
        ("discretize_on_midpoints", (np.cos, np.linspace(0, np.pi, 40)), {}),
        ("discretize_on_midpoints",
         (np.random.default_rng(1).standard_normal(50),
          np.linspace(0, 5, 50)), {}),
        ("discretize", (np.random.default_rng(1).standard_normal(49),
                        np.linspace(0, 5, 50)), {}),
    ],
)
def test_discretization_equal(name, args, kwargs):
    want = getattr(qp, name)(*args, **kwargs)
    got = getattr(qt, name)(*args, **kwargs)
    np.testing.assert_array_equal(got, want)


def test_evaluate_and_t_mid_equal():
    eps = lambda t: np.sin(t)
    vals = np.arange(20.0)
    on_points = np.arange(21.0)
    for n in range(20):
        assert qt.t_mid(TLIST, n) == qp.t_mid(TLIST, n)
        assert qt.evaluate(eps, TLIST, n) == qp.evaluate(eps, TLIST, n)
        assert qt.evaluate(vals, TLIST, n) == qp.evaluate(vals, TLIST, n)
        assert qt.evaluate(on_points, TLIST, n) == \
            qp.evaluate(on_points, TLIST, n)
    override = qt.IdDict([(eps, 42.0)])
    assert qt.evaluate(eps, TLIST, 3, vals_dict=override) == 42.0
    with pytest.raises(ValueError):
        qt.evaluate(vals, 2.5)
    with pytest.raises(ValueError):
        qt.discretize(np.zeros(5), np.linspace(0, 1, 10))


@pytest.mark.parametrize(
    "shape, kwargs",
    [
        ("box", dict(t_start=1.0, t_stop=3.0)),
        ("blackman", dict(t_start=0.5, t_stop=4.0)),
        ("blackman", dict(t_start=0.5, t_stop=4.0, a=0.2)),
        ("flattop", dict(T=4.0, t_rise=1.0)),
        ("flattop", dict(T=4.0, t_rise=1.0, func="sinsq")),
        ("flattop", dict(T=4.0, t_rise=0.5, t_fall=1.5, t0=0.2)),
        ("flattop", dict(T=4.0, t_rise=0.0)),
    ],
)
def test_shapes_equal(shape, kwargs):
    t = np.linspace(-0.5, 4.5, 101)
    want = getattr(qp, shape)(t, **kwargs)
    got = getattr(qt, shape)(t, **kwargs)
    np.testing.assert_array_equal(got, want)
    assert qt.flattop(2.0, T=4.0, t_rise=1.0) == qp.flattop(2.0, T=4.0,
                                                              t_rise=1.0)


def _ops():
    rng = np.random.default_rng(11)
    H0 = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    H0 = H0 + H0.conj().T
    H1 = np.diag(rng.standard_normal(4)).astype(complex)
    H2 = np.fliplr(np.eye(4)).astype(complex)
    return H0, H1, H2


def test_hamiltonian_structure_and_tables_equal():
    H0, H1, H2 = _ops()
    eps1 = lambda t: np.sin(t)
    eps2 = lambda t: 0.5 * np.cos(2 * t) + 0.1
    jgen = qp.hamiltonian(jnp.asarray(H0), (jnp.asarray(H1), eps1),
                          (jnp.asarray(H2), eps2), (jnp.asarray(H2), eps1))
    tgen = qt.hamiltonian(torch.as_tensor(H0), (torch.as_tensor(H1), eps1),
                          (torch.as_tensor(H2), eps2),
                          (torch.as_tensor(H2), eps1))
    assert isinstance(tgen, qt.Generator)
    assert len(tgen.ops) == len(jgen.ops) == 3
    assert tgen.amplitudes == jgen.amplitudes
    for a, b in zip(tgen.ops, jgen.ops):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-15)
    assert qt.get_controls(tgen) == qp.get_controls(jgen)
    np.testing.assert_array_equal(coeff_table_np(tgen, TLIST),
                                  jax_table(jgen, TLIST))
    np.testing.assert_array_equal(qt.coeff_table(tgen, TLIST).numpy(),
                                  np.asarray(qp.coeff_table(jgen, TLIST)))
    # carried over from JAX, the generator evaluates the same everywhere
    carried = from_jax(jgen)
    for n in (0, 7, 19):
        np.testing.assert_allclose(
            qt.evaluate(carried, TLIST, n).to_dense().numpy(),
            np.asarray(qp.evaluate(jgen, TLIST, n).to_dense()),
            rtol=0, atol=1e-14,
        )


def test_hamiltonian_static_and_drift_cases():
    H0, H1, H2 = _ops()
    op = qt.hamiltonian(torch.as_tensor(H0), (torch.as_tensor(H1), 2.0))
    jop = qp.hamiltonian(jnp.asarray(H0), (jnp.asarray(H1), 2.0))
    assert isinstance(op, qt.Operator)
    np.testing.assert_allclose(op.to_dense().numpy(),
                               np.asarray(jop.to_dense()), atol=1e-14)
    np.testing.assert_array_equal(coeff_table_np(op, TLIST),
                                  jax_table(jop, TLIST))
    drift = qt.hamiltonian(torch.as_tensor(H0), torch.as_tensor(H2))
    np.testing.assert_allclose(drift.numpy(), H0 + H2, atol=1e-15)
    with pytest.raises(ValueError, match="no terms"):
        qt.hamiltonian()
    with pytest.warns(UserWarning, match="reversed"):
        with pytest.raises(AttributeError):
            qt.hamiltonian(torch.as_tensor(H0),
                           (lambda t: 1.0, torch.as_tensor(H1)))


def test_liouvillian_equal():
    H0 = np.diag([0.5, -0.5]).astype(complex)
    H1 = np.array([[0, 1], [1, 0]], dtype=complex)
    A = np.array([[0, 1], [0, 0]], dtype=complex)
    eps = lambda t: np.cos(t)
    jL = qp.liouvillian((jnp.asarray(H0), (jnp.asarray(H1), eps)),
                        [jnp.asarray(A)], convention="TDSE")
    tL = qt.liouvillian((torch.as_tensor(H0), (torch.as_tensor(H1), eps)),
                        [torch.as_tensor(A)], convention="TDSE")
    assert isinstance(tL, qt.Generator) and tL.amplitudes[0] is eps
    for a, b in zip(tL.ops, jL.ops):
        np.testing.assert_allclose(a.to_dense().numpy(),
                                   np.asarray(b.to_dense()), atol=1e-15)
