"""``bench_torch.py`` (the port's benchmark script) against ``bench.py``
and the JAX package, on the CPU at small sizes.

Every mode returns the JSON line of its ``bench.py`` counterpart: the
metric, unit and keys are read from ``bench.py``'s dict literals with
``ast`` (``bench.py`` is never imported) and checked by
``chip_smoke.check_bench_line``, the check ``chip_smoke.py`` phase 13
runs on the card.  The headline's reference-tier step is held against
the JAX package's ``cheby_step_fused_dd`` (Pallas in interpret mode) on
the same inputs, and the transmon matvec counts against the JAX
package's propagators."""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch as bt
import chip_smoke
import quantumpropagators as qp
from quantumpropagators.ops.cheby import cheby_coeffs as jax_cheby_coeffs
from quantumpropagators.ops.fused_cheby import make_flip_plan as jax_plan
from quantumpropagators.ops.fused_cheby_dd import (
    cheby_step_fused_dd as jax_dd,
    f32_tail_orders as jax_tail,
)
from quantumpropagators.ops.operators import dia_from_scipy as jax_dia
from quantumpropagators.utils.timings import (
    disable_timings as jax_disable_timings,
    enable_timings as jax_enable_timings,
)
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.models.lattice import ising_diagonal_np

# the package builds on the card by default; these tests run on the CPU
set_default_device("cpu")
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED = chip_smoke.bench_py_lines(os.path.join(ROOT, "bench.py"))
L_SMALL = 10  # the flip plan's smallest chain

# each mode at a small size: (bench.py function, call, extra keys the
# line holds besides bench.py's literal ones)
MODES = {
    "rabi": ("bench_rabi", lambda: bt.bench_rabi(CPU), ()),
    "transmon": ("bench_transmon", lambda: bt.bench_transmon(CPU),
                 chip_smoke.TRANSMON_KEYS),
    "newton": ("bench_newton", lambda: bt.bench_newton(CPU, N=128), ()),
    "optomech": ("bench_optomech",
                 lambda: bt.bench_optomech(CPU, R=16, batch=64), ()),
    "banded20": ("bench_banded20",
                 lambda: bt.bench_banded20(CPU, L_dim=L_SMALL), ()),
    "multiamp": ("bench_multiamp",
                 lambda: bt.bench_multiamp(CPU, L=L_SMALL, n_steps=5), ()),
    "northstar": ("bench_northstar",
                  lambda: bt.bench_northstar(CPU, n_steps=20, L=L_SMALL), ()),
    **{f"headline-{k}": ("main", lambda k=k: bt.bench_headline(
        CPU, L=L_SMALL, kernel=k, steps=5, L_ref=8),
        ("per_step_error_vs_f64", "f32_tail_orders") if k == "dd" else ())
       for k in ("dd", "fused", "planar", "complex")},
    "lattice2d": ("main", lambda: bt.bench_headline(
        CPU, lattice2d="2x5", kernel="dd", steps=5, L_ref=8),
        ("per_step_error_vs_f64",)),
}
_LINES = {}


def line_of(mode):
    if mode not in _LINES:
        _LINES[mode] = MODES[mode][1]()
    return _LINES[mode]


def test_bench_py_lines_parsed():
    """Every function of bench.py that prints a line is read, with the
    headline's literal keys."""
    assert set(EXPECTED) == {
        "bench_rabi", "bench_transmon", "bench_newton", "bench_optomech",
        "bench_banded20", "bench_multiamp", "bench_northstar", "main"}
    metric, unit, keys, extra = EXPECTED["main"]
    assert unit == "Gnnz/s" and keys == {"metric", "value", "unit",
                                         "vs_baseline", "extra"}
    assert extra == {"steps_per_s", "matvecs_per_step", "kernel",
                     "platform", "state_norm_after"}


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_has_bench_py_keys(mode):
    name, _, also = MODES[mode]
    line = line_of(mode)
    chip_smoke.check_bench_line(name, line, EXPECTED[name], also)
    assert line["card"] is None
    assert line["extra"].get("platform", "cpu") == "cpu"


def test_check_bench_line_rejects_bad_lines():
    line = dict(line_of("headline-dd"), extra=dict(line_of("headline-dd")
                                                   ["extra"]))
    for key, value in (("steps_per_s", float("nan")),
                       ("per_step_error_vs_f64", 2e-13)):
        bad = dict(line, extra=dict(line["extra"], **{key: value}))
        with pytest.raises(AssertionError):
            chip_smoke.check_bench_line("main", bad, EXPECTED["main"])
    del line["extra"]["kernel"]
    with pytest.raises(AssertionError, match="kernel"):
        chip_smoke.check_bench_line("main", line, EXPECTED["main"])


def dd_split(x64):
    x64 = np.asarray(x64, dtype=np.float64)
    hi = x64.astype(np.float32)
    return jnp.asarray(hi), jnp.asarray((x64 - hi.astype(np.float64))
                                        .astype(np.float32))


def test_headline_dd_step_matches_jax():
    """The headline's reference-tier step (start state, envelope,
    coefficients, f32 tail) against the JAX package's dd step on the
    same inputs, and the per-step error against the f64 host oracle."""
    p = bt.tfim_problem(CPU, L_SMALL)
    step, psi, tail = bt.dd_stepper(p, CPU)
    got = step(psi).numpy()
    c = jax_cheby_coeffs(p.delta, p.dt)
    assert tail == jax_tail(c) > 0
    assert len(p.coeffs) == len(c)
    assert line_of("headline-dd")["extra"]["matvecs_per_step"] == len(c) - 1
    assert line_of("headline-dd")["extra"]["f32_tail_orders"] == tail
    dmb = ising_diagonal_np(p.L, p.bonds, bt.J_TFIM, bt.H_TFIM) \
        - (p.delta / 2 + p.e_min)
    out = jax_dd(jax_plan(p.L, bt.G_TFIM, tile_rows=8), *dd_split(dmb),
                 (*dd_split(p.re32), *dd_split(p.im32)), *dd_split(c),
                 p.delta, p.e_min, p.dt, f32_tail=tail, interpret=True)
    o = [np.asarray(x, dtype=np.float64) for x in out]
    assert np.abs(got - (o[0] + o[1] + 1j * (o[2] + o[3]))).max() < 1e-12
    assert line_of("headline-dd")["extra"]["per_step_error_vs_f64"] <= 1e-13


def test_northstar_round_trip():
    ex = line_of("northstar")["extra"]
    assert ex["round_trip_2000_step_err"] < 1e-12
    assert ex["per_step_err_vs_f64_oracle"] < 1e-13
    assert ex["norm_drift"] < 1e-12
    c = jax_cheby_coeffs(2 * (bt.J_TFIM * 9 + bt.H_TFIM * 10
                              + bt.G_TFIM * 10), 0.05)
    assert ex["matvecs_per_step"] == len(c) - 1
    assert ex["f32_tail_orders"] == jax_tail(c)


def test_transmon_matvec_counts_match_jax():
    """Newton and Chebyshev matvecs over the 100 steps equal the JAX
    package's propagators' counters on the same ladder and envelope."""
    H0, Hd, eps = bt.transmon_ladder()
    gen = qp.hamiltonian(jax_dia(H0), (jax_dia(Hd), eps))
    ev = np.concatenate([np.linalg.eigvalsh(H0.toarray() + s * Hd.toarray())
                         for s in (-0.3, 0.3)])
    buf = 0.02 * (ev.max() - ev.min())
    sr = dict(specrange_method="manual", E_min=float(ev.min() - buf),
              E_max=float(ev.max() + buf))
    psi0 = jnp.asarray(np.eye(10)[0].astype(complex))
    tlist = np.linspace(0.0, 10.0, 101)
    ex = line_of("transmon")["extra"]
    jax_enable_timings()
    try:
        for method, kw in (("cheby", sr),
                           ("newton", {"m_max": 8, "precision": "native"})):
            prop = qp.init_prop(psi0, gen, tlist, method=method, **kw)
            while qp.prop_step(prop) is not None:
                pass
            assert ex[f"{method}_matvecs_per_100_steps"] == \
                prop.timing_data.counters["matvec"] > 0
    finally:
        jax_disable_timings()
    assert ex["newton_dd_err_vs_f64_oracle"] < 1e-10
    assert ex["leja_dd_err_vs_f64_oracle"] < 1e-10


def test_script_imports_no_jax():
    """bench_torch.py imports neither jax nor the JAX package nor
    bench.py: no import statement names them, and a process that imports
    the script and runs a headline mode on the CPU has loaded none."""
    tree = ast.parse(open(os.path.join(ROOT, "bench_torch.py")).read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert not {n for n in names
                if n.split(".")[0] in ("jax", "quantumpropagators", "bench")}
    code = (
        "import sys, torch, bench_torch\n"
        "bench_torch.bench_headline(torch.device('cpu'), L=10, steps=1, "
        "L_ref=8)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'quantumpropagators', 'bench')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_script_without_gpu_raises(monkeypatch, capsys):
    """With no GPU and no ``--device cpu`` the script raises through
    ``resolve_device`` and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script runs on it")
    monkeypatch.setattr(sys, "argv", ["bench_torch.py", "--config", "rabi"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.main()
    assert capsys.readouterr().out == ""
