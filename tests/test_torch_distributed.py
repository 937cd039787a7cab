"""Port vs JAX package: checkpoints (mirrors ``test_checkpoint.py``), the
shard-slot mesh's collectives, and a 2-process × 2-slot run over gloo
(mirrors ``test_multihost.py``).

Run as ``python tests/test_torch_distributed.py <port> <rank>`` this
file is the worker of the 2-process test: it joins a 2-rank gloo group
on ``localhost:<port>``, runs the sharded steps on a 4-slot mesh (and
the fused flip steps on a 32-slot one) over that group and on the same
mesh in this process alone, and prints the largest difference of
each."""

import json
import os
import signal
import socket
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

import quantumpropagators_torch as qt
from quantumpropagators_torch.parallel.distributed import (
    load_checkpoint,
    propagator_checkpoint_state,
    restore_propagator,
    save_checkpoint,
)
from quantumpropagators_torch.parallel.mesh import (
    chain_mesh,
    replicate,
    shard_vector,
)
from quantumpropagators_torch.utils.fixtures import (
    random_matrix,
    random_state_vector,
)

qt.set_default_device("cpu")


# ---- checkpoints ------------------------------------------------------------


@pytest.fixture
def problem():
    rng = np.random.default_rng(123)
    N = 12
    H0 = random_matrix(N, hermitian=True, spectral_radius=2, rng=rng)
    H1 = random_matrix(N, hermitian=True, spectral_radius=1, rng=rng)
    gen = qt.hamiltonian(torch.as_tensor(H0), (torch.as_tensor(H1), np.sin))
    tlist = np.linspace(0, 2, 41)
    psi0 = torch.as_tensor(random_state_vector(N, rng=rng))
    return gen, tlist, psi0


def test_resume_mid_propagation(problem, tmp_path):
    """Interrupt after 20 steps, checkpoint, load the checkpoint through
    the JAX package's ``load_checkpoint``, restore into a fresh
    propagator and finish: matches the uninterrupted propagation."""
    from quantumpropagators.parallel.distributed import \
        load_checkpoint as jax_load

    gen, tlist, psi0 = problem
    ref = qt.propagate(psi0, gen, tlist, method="cheby")
    prop = qt.init_prop(psi0, gen, tlist, method="cheby")
    for _ in range(20):
        prop.prop_step()
    save_checkpoint(tmp_path / "ckpt", propagator_checkpoint_state(prop))

    theirs = jax_load(tmp_path / "ckpt")
    ours = load_checkpoint(tmp_path / "ckpt")
    assert sorted(theirs) == sorted(ours)
    for key in ("state", "t", "n", "backward"):
        assert np.array_equal(theirs[key], ours[key])
    assert np.array_equal(theirs["state"], prop.state.numpy())
    prop2 = qt.init_prop(psi0, gen, tlist, method="cheby")
    restore_propagator(prop2, theirs)
    assert prop2.t == pytest.approx(tlist[20])
    while prop2.prop_step() is not None:
        pass
    assert float((prop2.state - ref).abs().max()) < 1e-12


def test_checkpoint_includes_parameters(problem, tmp_path):
    from quantumpropagators.parallel.distributed import \
        load_checkpoint as jax_load

    gen, tlist, psi0 = problem
    prop = qt.init_prop(psi0, gen, tlist, method="cheby")
    for c in prop.controls:
        prop.parameters[c] = 2.0 * np.asarray(prop.parameters[c])
    save_checkpoint(tmp_path / "c2", propagator_checkpoint_state(prop))
    loaded = jax_load(tmp_path / "c2")
    assert sorted(loaded["parameters"]) == ["0"]
    prop2 = qt.init_prop(psi0, gen, tlist, method="cheby")
    restore_propagator(prop2, load_checkpoint(tmp_path / "c2"))
    for c in prop2.controls:
        assert np.allclose(np.asarray(prop2.parameters[c]),
                           np.asarray(prop.parameters[c]))


# ---- the mesh in one process --------------------------------------------------


def test_mesh_collectives_one_process():
    mesh = chain_mesh(4, device="cpu")
    assert (mesh.n_local, mesh.world_size, mesh.first_slot) == (4, 1, 0)
    x = torch.arange(8.0).reshape(4, 2)
    # a partial permutation: slots without a source get zeros
    got = mesh.ppermute(x, [(0, 1), (1, 2)])
    assert torch.equal(got, torch.tensor([[0., 0.], [0., 1.], [2., 3.],
                                          [0., 0.]]))
    got = mesh.ppermute(x, [(i, i ^ 2) for i in range(4)])
    assert torch.equal(got, x[[2, 3, 0, 1]])
    left, right = mesh.halos(x, 1)  # a ring of 4 slots
    assert torch.equal(left[:, 0], x[[3, 0, 1, 2], 1])
    assert torch.equal(right[:, 0], x[[1, 2, 3, 0], 0])
    assert torch.equal(mesh.all_gather(x), x)
    assert torch.equal(mesh.psum(x), x.sum(0))
    v = torch.arange(16.0)
    assert torch.equal(shard_vector(mesh, v), v.view(4, 4))
    assert mesh.local(v).data_ptr() == v.data_ptr()
    assert torch.equal(replicate(mesh, np.ones(3)), torch.ones(3,
                                                              dtype=torch.float64))
    with pytest.raises(ValueError, match="slots"):
        mesh.local_rows(torch.zeros(3, 2))
    with pytest.raises(ValueError, match="divisible"):
        shard_vector(mesh, torch.zeros(6))


# ---- two processes over gloo ----------------------------------------------


def _sharded_runs(mesh):
    """The sharded steps on ``mesh`` from fixed seeds; returns every
    slot's result (gathered) and a norm through ``psum``."""
    import scipy.sparse as sp

    from quantumpropagators_torch.ops.cheby import cheby_coeffs
    from quantumpropagators_torch.parallel import sharded_banded as sbd
    from quantumpropagators_torch.parallel import sharded_bsr as sbsr
    from quantumpropagators_torch.parallel import sharded_chain as sch
    from quantumpropagators_torch.parallel import sharded_fused as sf

    out = {}
    rng = np.random.default_rng(7)

    def gather(x):
        return mesh.all_gather(mesh.local(x)).reshape(-1)

    # fused flip step, both tiers: 2^12 over 4 slots
    L, g = 12, 1.2
    H_diag, H_x = qt.transverse_field_ising(L, J=1.0, g=g, h=0.3,
                                            dtype=torch.float64, device="cpu")
    bound = (L - 1) + 0.3 * L + g * L
    e_min, delta, dt = -bound, 2 * bound, 0.06
    coeffs = cheby_coeffs(delta, dt)
    psi = torch.as_tensor(random_state_vector(2 ** L, rng=rng))
    diag = H_diag.diag
    step = sf.make_sharded_fused_cheby_step_dd(mesh, L, g, delta=delta,
                                               e_min=e_min, dt=dt, f32_tail=3)
    out["fused_dd"] = gather(step(
        shard_vector(mesh, diag - (delta / 2 + e_min)),
        shard_vector(mesh, psi), coeffs, flip_scale=0.8))
    step32 = sf.make_sharded_fused_cheby_step(mesh, L, g, delta=delta,
                                              e_min=e_min, dt=dt)
    r, i = step32(shard_vector(mesh, diag), shard_vector(mesh, psi.real),
                  shard_vector(mesh, psi.imag), coeffs)
    out["fused"] = gather(torch.complex(r, i))

    # chain step with prepared site terms: 2^8 over 4 slots
    H_diag, H_x = qt.transverse_field_ising(8, J=1.0, g=1.2, h=0.3,
                                            dtype=torch.complex128,
                                            device="cpu")
    op = sch.prepare_sharded_operator(qt.Operator([H_diag, H_x], [1.0]), 4)
    cstep = sch.make_sharded_cheby_step(mesh, op, delta=30.0, e_min=-15.0,
                                        dt=0.1)
    psi = torch.as_tensor(random_state_vector(2 ** 8, rng=rng))
    out["chain"] = gather(cstep(op, shard_vector(mesh, psi),
                                cheby_coeffs(30.0, 0.1)))

    # BSR dd and banded dd steps: 16 block rows of b = 8
    N = 128
    A = sp.diags([rng.normal(size=N - 9), rng.normal(size=N - 1),
                  rng.normal(size=N), rng.normal(size=N - 1),
                  rng.normal(size=N - 9)], [-9, -1, 0, 1, 9]).tocsr()
    A = (0.5 * (A + A.T)).tocsr()
    bound = float(np.abs(A).sum(axis=1).max())
    kw = dict(delta=2 * bound, e_min=-bound, dt=0.05)
    coeffs = cheby_coeffs(2 * bound, 0.05)
    psi = torch.as_tensor(random_state_vector(N, rng=rng))
    pbdd = sbsr.partition_bsr_dd(A, 4, block_size=8, device="cpu")
    bstep = sbsr.make_sharded_bsr_cheby_step_dd(mesh, pbdd, **kw)
    out["bsr_dd"] = gather(bstep(pbdd, shard_vector(mesh, psi), coeffs))
    pb, kstep, kind = sbd.make_sharded_dd_cheby_step(
        mesh, A, 4, tile_rows=2, block_size=8, **kw)
    assert kind == "banded_pallas"
    y = kstep(pb, shard_vector(mesh, psi), coeffs)
    out["banded_dd"] = gather(y)
    out["norm"] = mesh.psum((y.abs() ** 2).sum(-1)).sqrt()

    # the Krylov methods through DistributedBSR: reductions over psum
    from quantumpropagators_torch.ops.expv import expv_apply
    from quantumpropagators_torch.ops.newton import newton_apply
    from quantumpropagators_torch.ops.specrange import specrange

    dop = sbsr.DistributedBSR(mesh, sbsr.partition_bsr(A, 4, block_size=8,
                                                       device="cpu"))
    x = shard_vector(mesh, psi)
    out["newton"] = gather(newton_apply(dop, x, 0.05, m_max=12))
    out["expv"] = gather(expv_apply(dop, x, 0.05, m=20))
    out["specrange"] = torch.tensor(specrange(dop, method="arnoldi",
                                              state=x, m_max=20))
    return out


def _wide_runs(mesh):
    """Both fused flip steps on a 32-slot ``mesh`` at L = 15 (2^10 a
    slot, the flip plan's least): five slot bits, each a partner of
    every flip call; returns every slot's result (gathered)."""
    from quantumpropagators_torch.ops.cheby import cheby_coeffs
    from quantumpropagators_torch.parallel import sharded_fused as sf

    L, g = 15, np.random.default_rng(9).uniform(0.8, 1.5, 15)
    H_diag, _ = qt.transverse_field_ising(L, J=1.0, g=1.2, h=0.3,
                                          dtype=torch.float64, device="cpu")
    bound = (L - 1) + 0.3 * L + float(g.sum())
    kw = dict(delta=2 * bound, e_min=-bound, dt=0.06)
    coeffs = cheby_coeffs(2 * bound, 0.06)
    psi = torch.as_tensor(random_state_vector(
        2 ** L, rng=np.random.default_rng(8)))
    diag = H_diag.diag

    def gather(x):
        return mesh.all_gather(mesh.local(x)).reshape(-1)

    step = sf.make_sharded_fused_cheby_step_dd(mesh, L, g, f32_tail=3, **kw)
    out = {"fused_dd_32": gather(step(
        shard_vector(mesh, diag - (kw["delta"] / 2 + kw["e_min"])),
        shard_vector(mesh, psi), coeffs, flip_scale=0.8))}
    step32 = sf.make_sharded_fused_cheby_step(mesh, L, g, **kw)
    r, i = step32(shard_vector(mesh, diag), shard_vector(mesh, psi.real),
                  shard_vector(mesh, psi.imag), coeffs)
    out["fused_32"] = gather(torch.complex(r, i))
    return out


def _worker(port: str, rank: int) -> None:
    import torch.distributed as dist

    from quantumpropagators_torch.parallel.distributed import \
        initialize_multihost

    group = initialize_multihost(f"localhost:{port}", 2, rank)
    try:
        assert dist.get_backend() == "gloo"
        mesh = chain_mesh(4, group=group, device="cpu")
        assert (mesh.n_local, mesh.first_slot) == (2, 2 * rank)
        two = _sharded_runs(mesh)
        one = _sharded_runs(chain_mesh(4, device="cpu"))
        # 16 slots a rank: four slot bits inside the rank, one received
        wide = chain_mesh(32, group=group, device="cpu")
        assert (wide.n_local, wide.first_slot) == (16, 16 * rank)
        two.update(_wide_runs(wide))
        one.update(_wide_runs(chain_mesh(32, device="cpu")))
        errs = {k: float((two[k] - one[k]).abs().max()) for k in one}
        print(f"OK rank={rank} {json.dumps(errs)}", flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextmanager
def _deadline(seconds: int):
    """Hard SIGALRM guard, as ``test_multihost.py`` has: raises in the
    test process wherever it is stuck."""

    def _raise(signum, frame):
        raise TimeoutError(f"test exceeded {seconds}s deadline")

    old = signal.signal(signal.SIGALRM, _raise)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def test_two_process_sharded_steps_match_one_process():
    """2 processes × 2 slots over gloo: every sharded step equals the
    same 4-slot mesh in one process to 1e-14 (and 2 × 16 slots the
    32-slot mesh, the fused steps' partners mixing the rank's own rows
    with received ones), and Newton, expv and
    specrange through DistributedBSR (whose reductions sum in another
    order over two ranks) to 1e-12."""
    repo = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=repo)
    port = str(_free_port())
    procs = []
    try:
        with _deadline(150):
            procs = [subprocess.Popen(
                [sys.executable, __file__, port, str(rank)], env=env,
                cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True) for rank in (0, 1)]
            outs = [p.communicate(timeout=120) + (p.returncode,)
                    for p in procs]
    except (subprocess.TimeoutExpired, TimeoutError) as exc:
        for p in procs:
            p.kill()
        pytest.fail(f"gloo workers timed out ({exc})")
    for out, err, rc in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out}\n{err[-3000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("OK rank=")]
        assert line, out
        errs = json.loads(line[0].split(" ", 2)[2])
        krylov = {"newton", "expv", "specrange"}
        assert set(errs) == {"fused_dd", "fused", "chain", "bsr_dd",
                             "banded_dd", "norm", "fused_dd_32",
                             "fused_32"} | krylov
        assert max(v for k, v in errs.items() if k not in krylov) <= 1e-14, \
            errs
        assert max(errs[k] for k in krylov) <= 1e-12, errs


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]))
