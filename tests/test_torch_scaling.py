"""``scaling_torch.py`` (the port's weak-scaling harness) against
``scaling.py`` and the JAX package, on CPU shard slots at small sizes.

Each regime's sharded step is held against the JAX package on the same
seeded inputs: the f32 chain against the JAX ``make_sharded_cheby_step``
on 8 virtual devices, the banded float64 operator (both builds, all
three exchanges) against the JAX ``make_sharded_bsr_cheby_step_dd`` (both
plain XLA), and the reference-accuracy chain against the JAX
``cheby_apply`` in complex128 (the JAX sharded dd step runs its Pallas
kernels in interpret mode, 20–140 s a call here).  Every mode's JSON
line is held against ``scaling.py``'s dict literals, read with ``ast``
by ``chip_smoke.scaling_py_lines``; one run spreads 4 slots over 2 gloo
processes (this file is its own worker:
``python tests/test_torch_scaling.py <port> <rank>``)."""

import ast
import json
import os
import signal
import socket
import subprocess
import sys
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chip_smoke
import scaling_torch as st
from quantumpropagators_torch import set_default_device
from quantumpropagators_torch.parallel import sharded_bsr as sbsr
from quantumpropagators_torch.parallel.mesh import chain_mesh

set_default_device("cpu")
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED = chip_smoke.scaling_py_lines(os.path.join(ROOT, "scaling.py"))
DT = 0.05
R_LOCAL, B = 4, 8
SMALL = ["--L-base", "10", "--R-local", str(R_LOCAL), "--block", str(B),
         "--steps", "2"]


def _full(x):
    return np.asarray(x.reshape(-1))


def _jax_mesh(n):
    from quantumpropagators.parallel.mesh import chain_mesh as jax_chain_mesh

    return jax_chain_mesh(n)


@pytest.fixture(scope="module")
def jax_hypercube():
    """One f32 step of the L = 10 chain on the JAX package's 8-device
    mesh, from ``scaling.py:run_config``'s inputs."""
    from quantumpropagators import Operator
    from quantumpropagators.models.lattice import transverse_field_ising
    from quantumpropagators.ops.cheby import cheby_coeffs
    from quantumpropagators.parallel.mesh import replicate, shard_vector
    from quantumpropagators.parallel.sharded_chain import (
        make_sharded_cheby_step, prepare_sharded_operator)

    L = 10
    H_diag, H_x = transverse_field_ising(L, J=st.J, g=st.G, h=st.H_FIELD,
                                         dtype=jnp.complex64)
    op = prepare_sharded_operator(
        Operator([H_diag, H_x], np.array([1.0], dtype=np.float32)), 8)
    e_min, delta = st._chain_envelope(L)
    mesh = _jax_mesh(8)
    step = make_sharded_cheby_step(mesh, op, delta=delta, e_min=e_min, dt=DT)
    psi = st._random_state(2 ** L, np.random.default_rng(0))
    v = shard_vector(mesh, jnp.asarray(psi, dtype=jnp.complex64))
    c = replicate(mesh, jnp.asarray(cheby_coeffs(delta, DT),
                                    dtype=jnp.float32))
    return np.asarray(step(op, v, c))


@pytest.mark.parametrize("n", [1, 2, 8])
def test_hypercube_step_matches_jax(jax_hypercube, n):
    p = st.build_hypercube(n, 10, DT, device=CPU)
    got = _full(p.step(p.state))
    assert p.nnz == 11 * 2 ** 10 and got.dtype == np.complex64
    assert np.abs(got - jax_hypercube).max() <= 1e-5


def _jax_banded_step(R, comm, n):
    """One step of the JAX package's sharded dd BSR step on the operator
    and start state ``scaling.py:run_config_banded_dd`` draws, its
    partition built by the JAX ``partition_bsr_dd`` from a dense copy
    (halo mode where it fits: the all-gather exchange is held against
    the JAX function by ``test_bsr_apply_dd_keyword_call_matches_jax``
    and computes the same product)."""
    from quantumpropagators.ops.cheby import cheby_coeffs
    from quantumpropagators.ops.df64_sparse import dd_split_np
    from quantumpropagators.parallel.mesh import shard_vector
    from quantumpropagators.parallel.sharded_bsr import (
        make_sharded_bsr_cheby_step_dd, partition_bsr_dd)

    rng = np.random.default_rng(17)
    diags = rng.normal(size=(R, B, B))
    offd = rng.normal(size=(R - 1, B, B))
    if comm == "none":
        offd = np.zeros_like(offd)
    A = np.zeros((R * B, R * B))
    for r in range(R):
        A[r * B:(r + 1) * B, r * B:(r + 1) * B] = \
            0.5 * (diags[r] + diags[r].T)
        if r + 1 < R:
            A[r * B:(r + 1) * B, (r + 1) * B:(r + 2) * B] = offd[r]
            A[(r + 1) * B:(r + 2) * B, r * B:(r + 1) * B] = offd[r].T
    psi = st._random_state(R * B, rng)
    pb = partition_bsr_dd(sp.csr_matrix(A), n, block_size=B)
    bound = np.abs(A).sum(axis=1).max()
    c64 = cheby_coeffs(2 * bound, DT)
    mesh = _jax_mesh(n)
    step = make_sharded_bsr_cheby_step_dd(mesh, pb, delta=2 * bound,
                                          e_min=-bound, dt=DT)
    state4 = tuple(shard_vector(mesh, p) for p in (*dd_split_np(psi.real),
                                                   *dd_split_np(psi.imag)))
    c_h, c_l = dd_split_np(c64)
    rh, rl, ih, il = (np.asarray(x, np.float64)
                      for x in step(pb, state4, c_h, c_l))
    return psi, (rh + rl) + 1j * (ih + il)


@pytest.fixture(scope="module")
def jax_banded():
    """The JAX steps by slot count, of the tridiagonal operator and of
    its block-diagonal part (``comm='none'``)."""
    return {(n, op): _jax_banded_step(R_LOCAL * n, op, n)
            for n in (1, 2, 4) for op in ("tridiagonal", "none")}


@pytest.mark.parametrize("comm", ["banded", "allgather", "none"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_banded_dd_step_matches_jax(jax_banded, n, comm):
    """Both builds of the port (scipy and ``partition_bsr_dd``, and the
    directly built planes forced by ``scipy_max=0``) against one JAX
    step, to 1e-12; the start state is ``scaling.py``'s."""
    psi, want = jax_banded[n, "none" if comm == "none" else "tridiagonal"]
    for scipy_max in (st.SCIPY_MAX_ENTRIES, 0):
        p = st.build_banded_dd(n, R_LOCAL, B, DT, comm, device=CPU,
                               scipy_max=scipy_max)
        assert np.abs(_full(p.state) - psi).max() == 0.0
        assert p.nnz == (3 * R_LOCAL * n - 2) * B * B
        got = _full(p.step(p.state))
        assert np.abs(got - want).max() <= 1e-12, (scipy_max, comm)


def test_banded_planes_layout():
    """The directly built planes carry ``scaling.py``'s halo widths and
    column ids: extended-local (wb = 1), global (wb = −1) and slot-local
    (wb = 0), padded blocks pointing at local ones."""
    halo = {}
    for comm in ("banded", "allgather", "none"):
        diags, offd = st.banded_blocks(8, 2, comm, np.random.default_rng(1))
        pb, bound = st.banded_planes(diags, offd, 2, comm,
                                     chain_mesh(2, device=CPU))
        halo[comm] = pb.halo_blocks
        assert tuple(pb.blocks.shape) == (2, 4, 3, 2, 2)
        assert bound > 0
        cols = pb.cols.numpy()
        assert cols.min() >= 0
        if comm == "allgather":
            assert cols.max() < 8
        else:
            assert cols.max() < 4 + 2 * max(pb.halo_blocks, 0)
    assert halo == {"banded": 1, "allgather": -1, "none": 0}


@pytest.fixture(scope="module")
def jax_hypercube_dd():
    """Two steps of the L = 13 chain by the JAX ``cheby_apply`` in
    complex128, from ``scaling.py:run_config_hypercube_dd``'s inputs."""
    import quantumpropagators as qp
    from quantumpropagators.models.lattice import transverse_field_ising
    from quantumpropagators.ops.cheby import cheby_apply, cheby_coeffs

    L = 13
    H_diag, H_x = transverse_field_ising(L, J=st.J, g=st.G, h=st.H_FIELD,
                                         dtype=jnp.complex128)
    op = qp.Operator([H_diag, H_x], np.array([1.0]))
    e_min, delta = st._chain_envelope(L)
    coeffs = jnp.asarray(cheby_coeffs(delta, DT))
    want = jnp.asarray(st._random_state(2 ** L, np.random.default_rng(0)))
    for _ in range(2):
        want = cheby_apply(op, want, coeffs, delta, e_min, DT)
    return np.asarray(want)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_hypercube_dd_steps_match_jax_cheby_apply(jax_hypercube_dd, n):
    """Two reference-accuracy steps of the L = 13 chain on 1, 2 and 8
    slots (at least 2^10 amplitudes a slot, the flip plan's smallest)
    against the JAX ``cheby_apply`` in complex128, to 1e-12."""
    L = 13
    p = st.build_hypercube_dd(n, L, DT, device=CPU)
    got = _full(p.step(p.step(p.state)))
    assert p.nnz == (L + 1) * 2 ** L and got.dtype == np.complex128
    assert np.abs(got - jax_hypercube_dd).max() <= 1e-12


def test_scaling_py_lines_parsed():
    """Both dict literals of scaling.py are read, every branch of their
    conditional strings listed."""
    by_metric = {m: e for e in EXPECTED for m in e[0]}
    assert set(by_metric) == {"weak_scaling_total_retention_shared_virtual",
                              "weak_scaling_efficiency",
                              "banded_halo_vs_allgather_gnnz_ratio"}
    main_line = by_metric["weak_scaling_efficiency"]
    assert len(main_line[1]) == 2 and len(main_line[2]) == 3
    assert {"regime", "tables", "note", "pass_criterion"} <= main_line[3]
    assert {"n_devices", "exchange_cost_vs_no_comm"} <= \
        by_metric["banded_halo_vs_allgather_gnnz_ratio"][3]


@pytest.mark.parametrize("mode", ["hypercube", "hypercube-dd", "banded-dd",
                                  "banded-vs-ag", "both", "all"])
def test_cli_mode_line(mode, capsys):
    """Every mode on 4 CPU slots: the printed line holds scaling.py's
    keys and its shared-slot branch, and tables the slot counts 1, 2, 4
    in the regimes of the mode."""
    out = st.main(["--mode", mode, "--cpu", "4", *SMALL])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    chip_smoke.check_scaling_line(printed, EXPECTED, None)
    if mode == "banded-vs-ag":
        assert out["n_devices"] == 4
        assert set(out["tables"]) == {"banded", "allgather", "no_comm",
                                      "size"}
        return
    regimes = {"hypercube": {"hypercube"}, "hypercube-dd": {"hypercube_dd"},
               "banded-dd": {"banded_dd"},
               "both": {"banded_dd", "hypercube"},
               "all": {"banded_dd", "hypercube", "hypercube_dd"}}[mode]
    assert set(out["tables"]) == regimes
    assert out["metric"] == "weak_scaling_total_retention_shared_virtual"
    assert out["regime"] == min(regimes, key=("banded_dd", "hypercube",
                                              "hypercube_dd").index)
    for table in out["tables"].values():
        assert sorted(table) == [1, 2, 4]
        assert table[1]["total_retention"] == 1.0


def test_one_slot_line_is_unshared(capsys):
    """One slot on one process is not shared: scaling.py's real-chip
    metric and no note."""
    out = st.main(["--mode", "banded-dd", "--cpu", "1", *SMALL])
    chip_smoke.check_scaling_line(out, EXPECTED, None)
    assert out["metric"] == "weak_scaling_efficiency"
    assert out["note"] is None and out["value"] == 1.0


def test_slot_counts():
    assert st.slot_counts(4, 1) == [1, 2, 4]
    assert st.slot_counts(8, 2) == [2, 4, 8]
    with pytest.raises(ValueError):
        st.slot_counts(6, 1)


def test_script_without_gpu_raises(capsys):
    """With no GPU and no ``--device cpu`` the script raises and prints
    no result."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.main(["--mode", "banded-dd"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", ["banded", "allgather"])
def test_bsr_apply_dd_keyword_call_matches_jax(name):
    """``banded_bsr_apply_dd`` and ``allgather_bsr_apply_dd`` take the JAX
    functions' ``pb=`` and ``x=`` keywords; the same call on one float64
    plane matches the JAX function (under ``shard_map``, one double-float
    plane pair) at R_local = 4, b = 8 on 4 slots."""
    from jax.sharding import PartitionSpec as P

    from quantumpropagators.ops.df64 import DD
    from quantumpropagators.parallel import sharded_bsr as jsb
    from quantumpropagators.parallel.mesh import STATE_AXIS, shard_vector

    n, R = 4, 4 * R_LOCAL
    rng = np.random.default_rng(5)
    diags, offd = st.banded_blocks(R, B, name, rng)
    A = st.banded_scipy(diags, offd)
    x64 = rng.normal(size=R * B)
    mode = "allgather" if name == "allgather" else "banded"
    jfn = getattr(jsb, f"{name}_bsr_apply_dd")
    jpb = jsb.partition_bsr_dd(A, n, block_size=B, mode=mode)
    meta = dict(halo_blocks=jpb.halo_blocks,
                n_block_rows_local=jpb.n_block_rows_local,
                n_devices=n, block_size=B, shape=jpb.shape)
    spec = jsb.PartitionedBSRdd(blocks_hi=P(STATE_AXIS),
                                blocks_lo=P(STATE_AXIS),
                                cols=P(STATE_AXIS), **meta)

    def fn(p, h, l):
        local = jsb.PartitionedBSRdd(blocks_hi=p.blocks_hi[0],
                                     blocks_lo=p.blocks_lo[0],
                                     cols=p.cols[0], **meta)
        y = jfn(pb=local, x=DD(h, l))
        return y.hi, y.lo

    mesh = _jax_mesh(n)
    xh = x64.astype(np.float32)
    xl = (x64 - xh.astype(np.float64)).astype(np.float32)
    yh, yl = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(spec, P(STATE_AXIS), P(STATE_AXIS)),
        out_specs=(P(STATE_AXIS), P(STATE_AXIS))))(
        jpb, shard_vector(mesh, jnp.asarray(xh)),
        shard_vector(mesh, jnp.asarray(xl)))
    want = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)

    tmesh = chain_mesh(n, device=CPU)
    pb = sbsr.partition_bsr_dd(A, n, block_size=B, mode=mode, device=CPU)
    port_fn = getattr(sbsr, f"{name}_bsr_apply_dd")
    got = port_fn(pb=pb, x=torch.as_tensor(x64).view(n, -1), mesh=tmesh)
    assert np.abs(_full(got) - want).max() <= 1e-12
    assert np.abs(_full(got) - A @ x64).max() <= 1e-12


def test_script_imports_no_jax():
    """scaling_torch.py imports neither jax nor the JAX package nor
    scaling.py: no import statement names them, and a process that
    imports it and runs a mode on the CPU has loaded none."""
    tree = ast.parse(open(os.path.join(ROOT, "scaling_torch.py")).read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert not {n for n in names
                if n.split(".")[0] in ("jax", "quantumpropagators",
                                       "scaling")}
    code = (
        "import sys, scaling_torch\n"
        "scaling_torch.main(['--mode', 'all', '--cpu', '1', '--L-base', "
        "'10', '--R-local', '4', '--block', '8', '--steps', '1'])\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'quantumpropagators', 'scaling')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _worker(port: str, rank: int) -> None:
    """One of 2 gloo ranks: one banded step on 4 slots spread over both
    ranks against the same 4 slots in this process, then the banded-dd
    mode's line (slot counts 2 and 4)."""
    import torch.distributed as dist

    from quantumpropagators_torch.parallel.distributed import \
        initialize_multihost

    group = initialize_multihost(f"localhost:{port}", 2, rank)
    try:
        assert dist.get_backend() == "gloo"
        errs = {}
        for comm in ("banded", "allgather"):
            two = st.build_banded_dd(4, R_LOCAL, B, DT, comm, device=CPU,
                                     group=group)
            one = st.build_banded_dd(4, R_LOCAL, B, DT, comm, device=CPU)
            assert two.mesh.n_local == 2
            got = two.mesh.all_gather(two.step(two.state))
            errs[comm] = float((got - one.step(one.state)).abs().max())
        out = st.main(["--mode", "banded-dd", "--cpu", "4", *SMALL])
        print(f"OK rank={rank} {json.dumps(errs)}", flush=True)
        if rank == 0:
            print("LINE " + json.dumps(out), flush=True)
        else:
            assert out is None
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextmanager
def _deadline(seconds: int):
    def _raise(signum, frame):
        raise TimeoutError(f"test exceeded {seconds}s deadline")

    old = signal.signal(signal.SIGALRM, _raise)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def test_two_process_banded_dd():
    """2 processes × 2 slots over gloo: the banded step equals the 4-slot
    mesh of one process to 1e-14 in halo and all-gather exchange, and
    rank 0 prints the banded-dd line with slot counts 2 and 4."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    port = str(_free_port())
    procs = []
    try:
        with _deadline(150):
            procs = [subprocess.Popen(
                [sys.executable, __file__, port, str(rank)], env=env,
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True) for rank in (0, 1)]
            outs = [p.communicate(timeout=120) + (p.returncode,)
                    for p in procs]
    except (subprocess.TimeoutExpired, TimeoutError) as exc:
        for p in procs:
            p.kill()
        pytest.fail(f"gloo workers timed out ({exc})")
    for out, err, rc in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out}\n{err[-3000:]}"
        ok = [ln for ln in out.splitlines() if ln.startswith("OK rank=")]
        assert ok, out
        errs = json.loads(ok[0].split(" ", 2)[2])
        assert set(errs) == {"banded", "allgather"}
        assert max(errs.values()) <= 1e-14, errs
    line = [ln for ln in outs[0][0].splitlines() if ln.startswith("LINE ")]
    assert line and not [ln for ln in outs[1][0].splitlines()
                         if ln.startswith("LINE ")]
    out = json.loads(line[0][5:])
    chip_smoke.check_scaling_line(out, EXPECTED, None)
    assert sorted(out["tables"]["banded_dd"]) == ["2", "4"]
    assert out["metric"] == "weak_scaling_total_retention_shared_virtual"


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]))
