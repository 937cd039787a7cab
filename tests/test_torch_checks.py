"""Port vs JAX package: the contract checkers (mirrors
``test_invalid_interfaces.py`` and ``test_prop_interfaces.py``;
reference ``test/test_invalid_interfaces.jl``,
``test/test_prop_interfaces.jl``).

Every case of ``test_invalid_interfaces.py`` runs on both packages with
the same inputs (JAX arrays there, CPU tensors here, and the same
duck-typed states, operators and amplitudes): the boolean each checker
returns and the messages it logs (on ``quantumpropagators.interfaces``
and ``quantumpropagators_torch.interfaces``) must be the same, and must
hold the JAX test's own expectation.  A message that quotes a library
exception (``"...: {exc}"``) must agree up to that quote, which is
NumPy/JAX text in one package and PyTorch text in the other.  The
``test_prop_interfaces.py`` cases run ``check_propagator`` and the
propagator contract on both packages' propagators."""

import logging
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumpropagators as qp
import quantumpropagators.interfaces as jax_checks
import quantumpropagators_torch as qt
import quantumpropagators_torch.interfaces as checks
from quantumpropagators.utils.fixtures import (random_dynamic_generator,
                                               random_matrix,
                                               random_state_vector)
from quantumpropagators_torch.interop import from_jax

# the duck-typed states, operators and amplitudes of the JAX test (host
# numpy inside, so both packages take them as they are)
from test_invalid_interfaces import (
    _ArrayLikeState,
    _BadAddState,
    _BadControlAmpl,
    _BadSizeDimsOp,
    _BadSubstituteAmpl,
    _BrokenScalarMulState,
    _BrokenSubState,
    _ConstantNormState,
    _LyingIterState,
    _NonConjugateDotState,
    _NonLinearOp,
    _NonNumericAmplitude,
    _NonTupleControlsAmpl,
    _RealArrayViewState,
    _SquaredNormState,
    _ThrowingApplyOp,
    _ThrowingEvaluateAmpl,
    _ThrowingNormState,
    _ThrowingShapeOp,
    _ZeroLengthState,
    _rand_duck,
)

qt.set_default_device("cpu")

TLIST = np.linspace(0, 1, 11)


class _Pkg:
    """One package's side of a case: its checkers, builders, arrays and
    propagator base class."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.qp, self.checks = qp, jax_checks
            self.logger = "quantumpropagators.interfaces"
            self.arr = jnp.asarray
        else:
            self.qp, self.checks = qt, checks
            self.logger = "quantumpropagators_torch.interfaces"
            self.arr = lambda x: torch.as_tensor(np.asarray(x))
        self.props = _propagator_classes(self.qp.propagators.Propagator,
                                         self.arr)

    def zeros(self, *shape):
        return self.arr(np.zeros(shape, dtype=complex))


class _StringOp:
    shape = (4, 4)

    def apply(self, psi):
        return "not a state"


def _boom(t):
    raise RuntimeError("control exploded")


def _propagator_classes(base, arr):
    """``test_invalid_interfaces.py``'s broken propagators over one
    package's ``Propagator`` base (and its arrays)."""

    class Stuck(base):
        """prop_step never advances t."""

        def __init__(self, state, tlist):
            self.state = state
            self.tlist = np.asarray(tlist)
            self.t = float(tlist[0])
            self.parameters = None
            self.backward = False

        def prop_step(self):
            return self.state

        def set_t(self, t):
            self.t = float(t)

        def _reinit(self, state, **kw):
            self.state = state
            self.t = float(self.tlist[0])

        def _next(self):
            i = int(np.searchsorted(self.tlist, self.t, side="right"))
            if i >= len(self.tlist):
                return False
            self.t = float(self.tlist[i])
            return True

    class NeverEnds(Stuck):
        def prop_step(self):
            self._next()
            return self.state

    class WrongShapeStep(Stuck):
        def prop_step(self):
            if not self._next():
                return None
            return arr(np.zeros(3, dtype=complex))

    class BadReinit(Stuck):
        def prop_step(self):
            return self.state if self._next() else None

        def _reinit(self, state, **kw):
            self.state = state
            self.t = float(self.tlist[-1])  # WRONG: does not reset t

    class NoSnapWarn(Stuck):
        def prop_step(self):
            return self.state if self._next() else None

        def set_t(self, t):
            idx = int(np.argmin(np.abs(self.tlist - float(t))))
            self.t = float(self.tlist[idx])  # silent snap

    class BadSetState(NoSnapWarn):
        def set_t(self, t):
            idx = int(np.argmin(np.abs(self.tlist - float(t))))
            if abs(self.tlist[idx] - float(t)) > 1e-12:
                warnings.warn(f"Snapping t={t} to grid")
            self.t = float(self.tlist[idx])

        def set_state(self, state):
            pass  # ignores the new state

    class NoParams:
        state = arr(np.zeros(2, dtype=complex))
        tlist = np.linspace(0, 1, 5)
        t = 0.0
        backward = False

        def prop_step(self):
            return None

    return dict(Stuck=Stuck, NeverEnds=NeverEnds,
                WrongShapeStep=WrongShapeStep, BadReinit=BadReinit,
                NoSnapWarn=NoSnapWarn, BadSetState=BadSetState,
                NoParams=NoParams)


def _psi(p, seed):
    return p.arr(random_state_vector(4, rng=np.random.default_rng(seed)))


def _wrong_shape_op(p):
    class WrongShapeOp:
        shape = (4, 4)

        def apply(self, psi):
            return p.zeros(3)

    return WrongShapeOp()


def _bad_control_generator(p):
    rng = np.random.default_rng(2)
    H0 = p.arr(random_matrix(4, hermitian=True, rng=rng))
    H1 = p.arr(random_matrix(4, hermitian=True, rng=rng))
    gen = p.qp.hamiltonian(H0, (H1, lambda t: "broken"))
    return p.checks.check_generator(gen, state=p.arr(random_state_vector(
        4, rng=rng)), tlist=TLIST)


def _mismatched_generator(p):
    rng = np.random.default_rng(13)
    H0 = p.arr(random_matrix(4, hermitian=True, rng=rng))
    H1 = p.arr(random_matrix(3, hermitian=True, rng=rng))
    try:
        p.qp.hamiltonian(H0, (H1, lambda t: 1.0))
    except ValueError:
        return "ValueError"
    return "no error"


def _bad_set_state(p):
    prop = p.props["BadSetState"](_psi(p, 17), TLIST)
    prop.prop_step()
    return p.checks.check_propagator(p.props["BadSetState"](_psi(p, 18),
                                                            TLIST))


#: test_invalid_interfaces.py, case by case: the call on one package, the
#: result the JAX test expects, and the texts of which one must appear in
#: the log ("" where the JAX test asks for any diagnostic, None where it
#: asks for none)
CASES = {
    "tlist_too_short": (lambda p: p.checks.check_tlist(np.array([1.0])),
                        False, ("at least 2 points",)),
    "tlist_not_monotonic": (lambda p: p.checks.check_tlist(
        np.array([0.0, 2.0, 1.0])), False, ("monotonically increasing",)),
    "tlist_not_vector": (lambda p: p.checks.check_tlist(np.zeros((3, 3))),
                         False, ("1D",)),
    "tlist_nonfinite": (lambda p: p.checks.check_tlist(
        np.array([0.0, 1.0, np.inf])), False, ("finite",)),
    "state_real_dtype": (lambda p: p.checks.check_state(p.arr(np.ones(4))),
                         False, ("complex",)),
    "state_unnormalized": (lambda p: p.checks.check_state(
        p.arr(2.0 * np.ones(4, dtype=complex)), normalized=True), False,
        ("normalized",)),
    "state_nonfinite": (lambda p: p.checks.check_state(
        p.arr(np.array([np.nan + 0j, 1.0]))), False, ("finite", "norm")),
    "state_broken_addition": (lambda p: p.checks.check_state(
        _rand_duck(_BadAddState, seed=0)), False, ("state + state",)),
    "operator_not_square": (lambda p: p.checks.check_operator(
        p.arr(np.ones((3, 4), dtype=complex)), tlist=TLIST), False,
        ("square",)),
    "operator_wrong_apply_shape": (lambda p: p.checks.check_operator(
        _wrong_shape_op(p), state=_psi(p, 1), tlist=TLIST), False,
        ("same shape",)),
    "control_returns_string": (lambda p: p.checks.check_control(
        lambda t: "nope", tlist=TLIST), False, ("float",)),
    "control_nonfinite_discretization": (lambda p: p.checks.check_control(
        lambda t: 1.0 / (t - t), tlist=TLIST), False, ("finite", "float")),
    "control_wrong_length_vector": (lambda p: p.checks.check_control(
        np.zeros(5), tlist=TLIST), False, ("",)),
    "amplitude_not_numeric": (lambda p: p.checks.check_amplitude(
        _NonNumericAmplitude(), tlist=TLIST), False, ("number",)),
    "generator_bad_control": (_bad_control_generator, False,
                              ("check_control", "float")),
    "propagator_stuck_time": (lambda p: p.checks.check_propagator(
        p.props["Stuck"](_psi(p, 3), TLIST)), False, ("one grid point",)),
    "propagator_never_returns_none": (lambda p: p.checks.check_propagator(
        p.props["NeverEnds"](_psi(p, 4), TLIST)), False,
        ("None past the end",)),
    "propagator_missing_property": (lambda p: p.checks.check_propagator(
        p.props["NoParams"]()), False, ("parameters",)),
    "duck_state_passes": (lambda p: p.checks.check_state(
        _rand_duck(_ArrayLikeState, seed=0)), True, None),
    "state_constant_norm": (lambda p: p.checks.check_state(
        _rand_duck(_ConstantNormState, seed=1)), False, ("norm",)),
    "state_squared_norm": (lambda p: p.checks.check_state(
        _rand_duck(_SquaredNormState, seed=2)), False, ("norm",)),
    "state_broken_scalar_mul": (lambda p: p.checks.check_state(
        _rand_duck(_BrokenScalarMulState, seed=3)), False, ("scalar", "homogeneous")),
    "state_broken_subtraction": (lambda p: p.checks.check_state(
        _rand_duck(_BrokenSubState, seed=4)), False, ("norm 0", "subtraction")),
    "state_nonconjugate_dot": (lambda p: p.checks.check_state(
        _rand_duck(_NonConjugateDotState, seed=5)), False, ("dot", "inner product")),
    "state_throwing_norm": (lambda p: p.checks.check_state(
        _rand_duck(_ThrowingNormState, seed=6)), False, ("norm",)),
    "state_zero_length": (lambda p: p.checks.check_state(
        _rand_duck(_ZeroLengthState, seed=7)), False, ("length", "len")),
    "state_lying_iteration": (lambda p: p.checks.check_state(
        _rand_duck(_LyingIterState, seed=8)), False, ("len(state)", "iterating")),
    "state_real_array_view": (lambda p: p.checks.check_state(
        _rand_duck(_RealArrayViewState, seed=9)), False, ("complex",)),
    "operator_throwing_apply": (lambda p: p.checks.check_operator(
        _ThrowingApplyOp(), state=_psi(p, 10), tlist=TLIST), False,
        ("applicable", "apply")),
    "operator_throwing_shape": (lambda p: p.checks.check_operator(
        _ThrowingShapeOp(), tlist=TLIST), False, ("shape",)),
    "operator_bad_size_dimensions": (lambda p: p.checks.check_operator(
        _BadSizeDimsOp(), tlist=TLIST), False, ("square", "shape")),
    "operator_nonlinear": (lambda p: p.checks.check_operator(
        _NonLinearOp(), state=_psi(p, 11), tlist=TLIST), False, ("",)),
    "operator_wrong_return_type": (lambda p: p.checks.check_operator(
        _StringOp(), state=_psi(p, 12), tlist=TLIST), False, ("",)),
    "amplitude_throwing_evaluate": (lambda p: p.checks.check_amplitude(
        _ThrowingEvaluateAmpl(), tlist=TLIST), False, ("evaluate",)),
    "amplitude_controls_not_tuple": (lambda p: p.checks.check_amplitude(
        _NonTupleControlsAmpl(), tlist=TLIST), False, ("tuple",)),
    "amplitude_bad_substitute": (lambda p: p.checks.check_amplitude(
        _BadSubstituteAmpl(), tlist=TLIST), False, ("substitute",)),
    "amplitude_with_invalid_control": (lambda p: p.checks.check_amplitude(
        _BadControlAmpl(), tlist=TLIST), False, ("check_control", "control")),
    "control_complex_valued": (lambda p: p.checks.check_control(
        lambda t: 1.0j * t, tlist=TLIST), False, ("float",)),
    "control_throwing": (lambda p: p.checks.check_control(
        _boom, tlist=TLIST), False, ("",)),
    "generator_mismatched_shapes": (_mismatched_generator, "ValueError",
                                    None),
    "generator_evaluates_to_invalid_operator": (
        lambda p: p.checks.check_generator(p.qp.hamiltonian(
            p.arr(np.ones((3, 4), dtype=complex)), check=False), state=None,
            tlist=TLIST), False, ("operator", "square")),
    "propagator_wrong_state_shape": (lambda p: p.checks.check_propagator(
        p.props["WrongShapeStep"](_psi(p, 14), TLIST)), False,
        ("same shape",)),
    "propagator_bad_reinit": (lambda p: p.checks.check_propagator(
        p.props["BadReinit"](_psi(p, 15), TLIST)), False, ("reinit",)),
    "propagator_silent_snap": (lambda p: p.checks.check_propagator(
        p.props["NoSnapWarn"](_psi(p, 16), TLIST)), False, ("warn",)),
    "propagator_bad_set_state": (_bad_set_state, False, ("set_state",)),
}


@pytest.fixture(scope="module")
def pkgs():
    return _Pkg("jax"), _Pkg("torch")


def _run(caplog, p, fn):
    """``fn(p)`` and the messages logged on ``p``'s logger meanwhile."""
    caplog.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with caplog.at_level(logging.ERROR, logger=p.logger):
            result = fn(p)
    return result, [r.getMessage() for r in caplog.records
                    if r.name == p.logger]


def _same_messages(want, got):
    """Equal messages; one that quotes an exception after its colon
    agrees up to the quote."""
    assert len(got) == len(want), (want, got)
    for w, g in zip(want, got):
        assert g == w or g.split(": ", 1)[0] == w.split(": ", 1)[0], (w, g)


@pytest.mark.parametrize("case", list(CASES))
def test_invalid_interface_twin(pkgs, caplog, case):
    fn, expected, texts = CASES[case]
    (want, want_msgs), (got, got_msgs) = (_run(caplog, p, fn) for p in pkgs)
    assert want == expected and got == want
    _same_messages(want_msgs, got_msgs)
    if texts is None:
        assert not got_msgs
    else:
        log = "\n".join(got_msgs)
        assert got_msgs and any(t in log for t in texts), got_msgs


def test_interface_names_match_jax():
    assert checks.__all__ == jax_checks.__all__
    for name in checks.__all__:
        assert getattr(qt, name) is getattr(checks, name)
    arr = np.zeros(3)
    assert checks.supports_inplace(arr) == jax_checks.supports_inplace(arr)
    # the port's propagators never mutate the caller's state
    assert not checks.supports_inplace(torch.zeros(3))
    for obj in (np.zeros(3), np.zeros((2, 2)), [1.0, 2.0], 3.0):
        for trait in ("supports_vector_interface", "supports_matrix_interface"):
            assert getattr(checks, trait)(obj) == getattr(jax_checks,
                                                          trait)(obj)
    assert checks.supports_vector_interface(torch.zeros(3))
    assert checks.supports_matrix_interface(torch.zeros((2, 2)))
    assert checks.supports_matrix_interface(qt.Operator([torch.eye(2)], []))


def test_parameterized_twin(pkgs, caplog):
    """check_parameterized_function / check_parameterized on a CRAB
    function and on a plain callable, in both packages."""
    for p in pkgs:
        f = p.qp.CRABFunction(4, max_frequency=5.0,
                              rng=np.random.default_rng(42))
        ok = (p.checks.check_parameterized_function(f, tlist=TLIST),
              p.checks.check_parameterized(f))
        assert ok == (True, True)
    for fn, expected in (
            (lambda p: p.checks.check_parameterized_function(
                lambda t: 1.0, tlist=TLIST), False),):
        (want, wm), (got, gm) = (_run(caplog, p, fn) for p in pkgs)
        assert want == got == expected
        _same_messages(wm, gm)


# -- test_prop_interfaces.py ---------------------------------------------------


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(33)
    tlist = np.linspace(0, 2, 21)
    gen = random_dynamic_generator(12, tlist, rng=rng)
    psi0 = jnp.asarray(random_state_vector(12, rng=rng))
    return (psi0, gen), (from_jax(psi0), from_jax(gen)), tlist


@pytest.mark.parametrize("method", ["cheby", "newton", "expprop"])
@pytest.mark.parametrize("backward", [False, True])
def test_contract_twin(pkgs, problem, caplog, method, backward):
    for p, (psi0, gen) in zip(pkgs, problem[:2]):
        prop = p.qp.init_prop(psi0, gen, problem[2], method=method,
                              backward=backward)
        ok, msgs = _run(caplog, p, lambda p: p.checks.check_propagator(prop))
        assert ok and not msgs, msgs


def test_propagator_errors_twin(pkgs, problem):
    """The generator firewall, an unknown method, a non-uniform grid."""
    for p, (psi0, gen) in zip(pkgs, problem[:2]):
        prop = p.qp.init_prop(psi0, gen, problem[2], method="cheby")
        with pytest.raises(AttributeError):
            prop.generator = gen
        with pytest.raises(ValueError, match="Unknown propagation method"):
            p.qp.init_prop(psi0, gen, problem[2], method="nosuchmethod")
        with pytest.warns(UserWarning, match="Non-uniform"):
            with pytest.raises(ValueError, match="uniform time grid"):
                p.qp.init_prop(psi0, gen, np.array([0.0, 0.1, 0.3, 0.6, 1.0]),
                               method="cheby")


def test_time_grid_twin(pkgs, problem):
    """set_t snaps up with a warning and moves the interval index."""
    tlist = problem[2]
    for p, (psi0, gen) in zip(pkgs, problem[:2]):
        prop = p.qp.init_prop(psi0, gen, tlist, method="expprop")
        with pytest.warns(UserWarning, match="Snapping"):
            prop.set_t(tlist[3] + 0.33 * (tlist[4] - tlist[3]))
        assert prop.t == pytest.approx(tlist[4])
        prop = p.qp.init_prop(psi0, gen, tlist, method="cheby")
        prop.set_t(tlist[5])
        assert prop.n == 5
        prop.prop_step()
        assert prop.t == pytest.approx(tlist[6])


def test_reinit_fast_path_twin(pkgs, problem):
    for p, (psi0, gen) in zip(pkgs, problem[:2]):
        prop = p.qp.init_prop(psi0, gen, problem[2], method="cheby")
        wrk = prop.wrk
        p.qp.reinit_prop(prop, psi0)
        assert prop.wrk is wrk
        for c in prop.controls:
            prop.parameters[c] = 0.5 * np.asarray(prop.parameters[c])
        p.qp.reinit_prop(prop, psi0)
        assert prop.wrk is wrk
        for c in prop.controls:
            prop.parameters[c] = 10.0 * np.asarray(prop.parameters[c])
        p.qp.reinit_prop(prop, psi0)
        assert prop.wrk is not wrk


def test_parameter_mutation_twin(pkgs, problem):
    """Zeroed parameters change the dynamics the same way in both."""
    finals = []
    for p, (psi0, gen) in zip(pkgs, problem[:2]):
        props = [p.qp.init_prop(psi0, gen, problem[2], method="expprop")
                 for _ in range(2)]
        for c in props[1].controls:
            props[1].parameters[c] = 0.0 * np.asarray(props[1].parameters[c])
        out = []
        for prop in props:
            while prop.prop_step() is not None:
                pass
            out.append(np.asarray(prop.state))
        assert np.linalg.norm(out[0] - out[1]) > 1e-6
        finals.append(out)
    assert np.abs(np.asarray(finals[0]) - np.asarray(finals[1])).max() < 1e-12


def test_auto_method_selection_twin(pkgs):
    rng = np.random.default_rng(5)
    tlist = np.linspace(0, 1, 11)
    H = random_dynamic_generator(12, tlist, rng=rng)
    psi = random_state_vector(12, rng=rng)
    SM = np.array([[0, 1], [0, 0]], dtype=complex)
    H0 = np.diag([0.5, -0.5]).astype(complex)
    rho0 = np.array([0, 0, 0, 1], dtype=complex)
    for p, gen in zip(pkgs, (H, from_jax(H))):
        props = p.qp.propagators
        prop = p.qp.init_prop(p.arr(psi), gen, tlist, method="auto")
        assert isinstance(prop, props.ChebyPropagator)
        L = p.qp.liouvillian(p.arr(H0), [p.arr(SM)], convention="TDSE")
        prop2 = p.qp.init_prop(p.arr(rho0), L, tlist, method="auto")
        assert isinstance(prop2, props.NewtonPropagator)
