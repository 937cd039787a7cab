"""The port's examples (``examples/*_torch.py``) against the same loops on
the JAX package, on the CPU.

- GRAPE: the first 5 iterations' infidelity and gradient against the
  JAX package's ``make_fused_cheby_propagator`` under
  ``jax.value_and_grad``, to 1e-10;
- Krotov: the guess fidelity and the first 3 iterations' fidelities
  against the JAX example's loop, to 1e-10;
- multi-amplitude: the port's ``kernel="dd"`` state after the first 5
  of the example's 100 steps against the JAX package's ``kernel="xla"``
  on the same inputs, to 1e-12 (the JAX generic path takes about 0.6 s
  a step here, and its ``kernel="dd"`` runs its Pallas kernel in
  interpret mode, minutes);
- the sharded chain: 5 steps on 4 slots against the JAX sharded step
  on 4 virtual devices, to 1e-5 (complex64).

The whole runs (GRAPE to its stop at iteration 63, Krotov to 21) are
made on the card by ``chip_smoke.py`` phase 14."""

import ast
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantumpropagators as qp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("grape_state_transfer", "krotov_state_transfer",
            "multi_amplitude_dd", "sharded_spin_chain")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SX = jnp.asarray([[0, 1], [1, 0]], dtype=complex)
SZ = jnp.asarray([[1, 0], [0, -1]], dtype=complex)


def test_grape_first_iterations_match_jax():
    from quantumpropagators.fused import make_fused_cheby_propagator
    from quantumpropagators.models.generators import coeff_table

    guess = lambda t: 0.3 * qp.flattop(t, T=2.0, t_rise=0.5)
    H = qp.hamiltonian(0.0 * SZ, (SX, guess))
    tlist = np.linspace(0, 2.0, 81)
    psi0 = jnp.asarray([1, 0], dtype=complex)
    target = jnp.asarray([0, 1], dtype=complex)
    propagate = make_fused_cheby_propagator(
        psi0, H, tlist, E_min=-4.0, E_max=4.0, specrange_method="manual")

    @jax.jit
    def jax_loss_and_grad(table):
        def infidelity(tb):
            psi_T, _ = propagate(psi0, tb)
            return 1.0 - jnp.abs(jnp.vdot(target, psi_T)) ** 2

        return jax.value_and_grad(infidelity)(table)

    loss_and_grad, table, t_port = _load("grape_state_transfer").problem(
        "cpu")
    jtable = jnp.asarray(coeff_table(H, tlist))
    assert np.array_equal(t_port, tlist)
    assert np.abs(table.numpy() - np.asarray(jtable)).max() <= 1e-15
    losses = []
    for _ in range(5):
        loss, grad = loss_and_grad(table)
        jloss, jgrad = jax_loss_and_grad(jtable)
        assert abs(float(loss) - float(jloss)) <= 1e-10
        assert np.abs(grad.numpy() - np.asarray(jgrad)).max() <= 1e-10
        table, jtable = table - 1.5 * grad, jtable - 1.5 * jgrad
        losses.append(float(loss))
    assert losses == sorted(losses, reverse=True)


def test_krotov_first_iterations_match_jax(capsys):
    """The JAX example's loop for 3 iterations (its propagators, aliasing
    and co-state sweep), against the port example's first 3."""
    H0 = 0.5 * SZ
    tlist = np.linspace(0, 5.0, 101)
    psi0 = jnp.asarray([1, 0], dtype=complex)
    target = jnp.asarray([0, 1], dtype=complex)
    guess = lambda t: 0.2 * qp.flattop(t, T=5.0, t_rise=1.0)
    gen = qp.hamiltonian(H0, (SX, guess))
    ranges = lambda: qp.IdDict([(guess, (-3.0, 3.0))])
    fwd = qp.init_prop(psi0, gen, tlist, method="cheby",
                       control_ranges=ranges())
    bwd = qp.init_prop(target, gen, tlist, method="cheby", backward=True,
                       control_ranges=ranges())
    control = fwd.controls[0]
    eps = np.asarray(fwd.parameters[control]).copy()
    fwd.parameters[control] = eps
    qp.reinit_prop(fwd, psi0)
    while fwd.prop_step() is not None:
        pass
    F0 = abs(complex(jnp.vdot(target, fwd.state))) ** 2
    nt, want = len(tlist), []
    for _ in range(3):
        bwd.parameters[control] = eps
        qp.reinit_prop(bwd, target)
        chi = np.zeros((nt, 2), dtype=complex)
        chi[-1] = np.asarray(bwd.state)
        n = nt - 2
        while bwd.prop_step() is not None:
            chi[n] = np.asarray(bwd.state)
            n -= 1
        new_eps = eps.copy()
        fwd.parameters[control] = new_eps
        qp.reinit_prop(fwd, psi0)
        for i in range(nt - 1):
            overlap = chi[i].conj() @ np.asarray(SX) @ np.asarray(fwd.state)
            new_eps[i] = eps[i] + 0.5 * np.imag(overlap)
            fwd.prop_step()
        want.append(abs(complex(jnp.vdot(target, fwd.state))) ** 2)
        eps = new_eps

    out = _load("krotov_state_transfer").main("cpu", max_iter=3)
    assert "guess fidelity: " in capsys.readouterr().out
    assert abs(out["guess_fidelity"] - F0) <= 1e-10
    assert out["iterations"] == 2
    assert np.abs(np.array(out["fidelities"]) - want).max() <= 1e-10
    assert want[0] < want[1] < want[2]


def test_multi_amplitude_dd_matches_jax_xla():
    from quantumpropagators.fused import cheby_propagate_fused
    from quantumpropagators.models.lattice import (SiteOperatorSum,
                                                   transverse_field_ising)

    mod = _load("multi_amplitude_dd")
    out = mod.main("cpu", n_steps=5)
    L = mod.L
    H_diag, _ = transverse_field_ising(L, J=1.0, g=1.0, h=0.3,
                                       dtype=jnp.float64)
    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    mats = {p: np.zeros((L, 2, 2)) for p in (0, 1)}
    for i in range(L):
        mats[i % 2][i] = sx
    Hx = {p: SiteOperatorSum(jnp.asarray(mats[p]), L=L,
                             active=tuple(i % 2 == p for i in range(L)))
          for p in (0, 1)}
    gen = qp.hamiltonian(
        (H_diag, lambda t: 1.0 + 0.3 * np.sin(0.9 * t)),
        (Hx[1], lambda t: 1.2 + 0.4 * np.cos(1.7 * t)),
        (Hx[0], lambda t: 0.9 + 0.5 * np.sin(2.3 * t)), check=False)
    rng = np.random.default_rng(0)
    psi0 = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    psi0 = jnp.asarray(psi0 / np.linalg.norm(psi0))
    bound = 1.3 * (1.0 * (L - 1) + 0.3 * L) + 1.6 * L
    want, _ = cheby_propagate_fused(
        psi0, gen, np.linspace(0.0, 2.0, 101)[:6], kernel="xla",
        specrange_method="manual", E_min=-bound, E_max=bound)
    assert out["err"] < 1e-12
    assert abs(out["norm"] - 1.0) <= 1e-12
    assert np.abs(out["psi_dd"].numpy() - np.asarray(want)).max() <= 1e-12


def test_sharded_chain_matches_jax():
    from quantumpropagators import Operator
    from quantumpropagators.models.lattice import transverse_field_ising
    from quantumpropagators.ops.cheby import cheby_coeffs
    from quantumpropagators.parallel.mesh import (chain_mesh, replicate,
                                                  shard_vector)
    from quantumpropagators.parallel.sharded_chain import (
        make_sharded_cheby_step, prepare_sharded_operator)

    out = _load("sharded_spin_chain").main("cpu", slots=4, n_steps=5)
    L = 14
    H_diag, H_x = transverse_field_ising(L, J=1.0, g=1.2, h=0.3,
                                         dtype=jnp.complex64)
    op = prepare_sharded_operator(
        Operator([H_diag, H_x], np.array([1.0], dtype=np.float32)), 4)
    bound = 1.0 * (L - 1) + 0.3 * L + 1.2 * L
    mesh = chain_mesh(4)
    step = make_sharded_cheby_step(mesh, op, delta=2 * bound, e_min=-bound,
                                   dt=0.05)
    rng = np.random.default_rng(0)
    psi = rng.standard_normal(2 ** L) + 1j * rng.standard_normal(2 ** L)
    v = shard_vector(mesh, jnp.asarray(psi / np.linalg.norm(psi),
                                       dtype=jnp.complex64))
    c = replicate(mesh, jnp.asarray(cheby_coeffs(2 * bound, 0.05),
                                    dtype=jnp.float32))
    for _ in range(5):
        v = step(op, v, c)
    got = out["state"]
    assert tuple(got.shape) == (4, 2 ** L // 4)
    assert got.dtype == torch.complex64
    assert np.abs(got.reshape(-1).numpy() - np.asarray(v)).max() <= 1e-5
    assert abs(out["norm"] - 1.0) <= 1e-5


def test_examples_import_no_jax():
    """No example imports jax, the JAX package or a JAX example, and a
    process that loads all four and runs the sharded chain and the
    multi-amplitude problem on the CPU has loaded none of them."""
    for name in EXAMPLES:
        path = os.path.join(ROOT, "examples", f"{name}_torch.py")
        tree = ast.parse(open(path).read())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)}
        assert not {n for n in names if n.split(".")[0] in
                    ("jax", "quantumpropagators", *EXAMPLES)}, name
    code = (
        "import importlib.util, sys\n"
        "mods = {}\n"
        f"for name in {EXAMPLES!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'examples/{name}_torch.py')\n"
        "    mods[name] = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mods[name])\n"
        "mods['sharded_spin_chain'].main('cpu', slots=2, n_steps=1)\n"
        "mods['multi_amplitude_dd'].problem('cpu')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'quantumpropagators')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_gpu_raises(name, capsys):
    """Each example runs on the card unless given ``device="cpu"``
    (``--device cpu``): with no GPU its ``main`` raises before it prints
    a result."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the example runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main()
    assert "fidelity" not in capsys.readouterr().out
