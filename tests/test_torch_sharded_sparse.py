"""Port vs JAX package: sharded chain, CSR, BSR and banded operators
(mirrors ``test_sharded_chain.py``, ``test_sharded_csr.py``,
``test_sharded_bsr.py`` and ``test_sharded_banded.py``) on meshes of 1, 2
and 8 shard slots in one process.

The JAX package's sharded applies and steps run once per module on its
8-device mesh, the BSR dd step on the double-float planes its tests
use.  Its banded Pallas step (one interpret-mode call takes 25-140 s
here) is held by its partition layout, by the JAX package's unsharded
``cheby_apply`` on the same operator and by the dense oracle its own
tests use."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch
from jax.sharding import PartitionSpec as P

import quantumpropagators as qp
import quantumpropagators_torch as qt
from quantumpropagators.models.lattice import transverse_field_ising
from quantumpropagators.ops.cheby import cheby_apply as jax_cheby_apply
from quantumpropagators.ops.cheby import cheby_coeffs
from quantumpropagators.parallel import mesh as jax_mesh
from quantumpropagators.parallel import sharded_banded as jax_sbd
from quantumpropagators.parallel import sharded_bsr as jax_sbsr
from quantumpropagators.parallel import sharded_chain as jax_sch
from quantumpropagators.parallel import sharded_csr as jax_scsr
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch.parallel import sharded_banded as sbd
from quantumpropagators_torch.parallel import sharded_bsr as sbsr
from quantumpropagators_torch.parallel import sharded_chain as sch
from quantumpropagators_torch.parallel import sharded_csr as scsr
from quantumpropagators_torch.parallel.mesh import chain_mesh

qt.set_default_device("cpu")

SLOTS = [1, 2, 8]
L_CHAIN, DT = 10, 0.1


def _mesh(slots):
    return chain_mesh(slots, device="cpu")


def _state(rng, n):
    psi = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return psi / np.linalg.norm(psi)


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _dd_split(x64):
    """The JAX double-float pair ``(hi, lo)`` of float32 planes."""
    hi = np.asarray(x64, np.float64).astype(np.float32)
    return hi, (x64 - hi.astype(np.float64)).astype(np.float32)


def random_banded(N, w, rng, density=0.6):
    """Hermitian complex CSR with nonzeros within ``w`` of the diagonal."""
    A = sp.random(N, N, density=density, random_state=np.random.RandomState(
        int(rng.integers(1 << 30))), data_rvs=rng.standard_normal)
    A = A + 1j * sp.random(N, N, density=density,
                           random_state=np.random.RandomState(
                               int(rng.integers(1 << 30))),
                           data_rvs=rng.standard_normal)
    A = sp.triu(sp.tril(A, w), -w)
    return (A + A.conj().T).tocsr()


def block_tridiag(R, b, rng, dtype=complex):
    rows, cols, blocks = [], [], []
    for r in range(R):
        for c in (r - 1, r, r + 1):
            if 0 <= c < R:
                B = rng.normal(size=(b, b))
                if dtype is complex:
                    B = B + 1j * rng.normal(size=(b, b))
                rows.append(r)
                cols.append(c)
                blocks.append(B)
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=R))]).astype(np.int64)
    return sp.bsr_matrix((np.stack(blocks), np.asarray(cols), indptr),
                         shape=(R * b, R * b)).tocsr()


# ---- chain -----------------------------------------------------------------


@pytest.fixture(scope="module")
def chain():
    H_diag, H_x = transverse_field_ising(L_CHAIN, J=1.0, g=1.2, h=0.3,
                                         dtype=jnp.complex128)
    op = qp.Operator([H_diag, H_x], np.array([1.0]))
    psi = _state(np.random.default_rng(17), 2 ** L_CHAIN)
    bound = (L_CHAIN - 1) + 0.3 * L_CHAIN + 1.2 * L_CHAIN
    e_min, delta = -bound, 2 * bound
    coeffs = cheby_coeffs(delta, DT)
    mesh = jax_mesh.chain_mesh(8)
    apply = jax.jit(jax.shard_map(
        lambda o, v: jax_sch.sharded_apply(o, v), mesh=mesh,
        in_specs=(jax_sch.operator_shard_spec(op), P("x")), out_specs=P("x")))
    op_sh = jax_sch.prepare_sharded_operator(op, 8, group_bits=4)
    step = jax_sch.make_sharded_cheby_step(mesh, op_sh, delta=delta,
                                           e_min=e_min, dt=DT)
    sv = jax_mesh.shard_vector(mesh, jnp.asarray(psi))
    return dict(op=op, psi=psi, e_min=e_min, delta=delta, coeffs=coeffs,
                op_sh=op_sh, apply=np.asarray(apply(op, sv)),
                step=np.asarray(step(op_sh, sv, jnp.asarray(coeffs))))


@pytest.mark.parametrize("slots", SLOTS)
def test_sharded_apply_matches_jax(chain, slots):
    mesh = _mesh(slots)
    op = from_jax(chain["op"])
    psi = torch.as_tensor(chain["psi"])
    got = sch.sharded_apply(sch.operator_shard_spec(op, mesh),
                            mesh.local(psi), mesh=mesh).reshape(-1)
    assert _rel(got.numpy(), chain["apply"]) < 1e-13


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("prepared", [False, True])
def test_sharded_cheby_step_matches_jax(chain, slots, prepared):
    """The chain step with per-site or prepared (``ShardedSiteSum``) site
    terms; the prepared operator is the port's own and the JAX one
    carried over."""
    mesh = _mesh(slots)
    op = from_jax(chain["op"])
    if prepared:
        op = sch.prepare_sharded_operator(op, slots, group_bits=4)
        if slots == 8:
            jop = from_jax(chain["op_sh"])
            assert isinstance(jop.ops[1], sch.ShardedSiteSum)
            assert jop.ops[1].device_active == op.ops[1].device_active
            assert torch.equal(jop.ops[1].device_mats, op.ops[1].device_mats)
    step = sch.make_sharded_cheby_step(mesh, op, delta=chain["delta"],
                                       e_min=chain["e_min"], dt=DT)
    got = step(op, torch.as_tensor(chain["psi"]), chain["coeffs"])
    assert np.abs(got.numpy() - chain["step"]).max() < 1e-12


# ---- CSR -------------------------------------------------------------------


@pytest.fixture(scope="module")
def csr():
    rng = np.random.default_rng(61)
    N = 256
    A = random_banded(N, 12, rng)
    B = (sp.random(N, N, density=0.05, random_state=np.random.RandomState(1))
         + 1j * sp.random(N, N, density=0.05,
                          random_state=np.random.RandomState(2))).tocsr()
    psi = _state(rng, N)
    mesh = jax_mesh.chain_mesh(8)
    sv = jax_mesh.shard_vector(mesh, jnp.asarray(psi))
    pa = jax_scsr.partition_csr_rows(B, 8)
    pb = jax_scsr.partition_csr_banded(A, 8)
    return dict(A=A, B=B, psi=psi, jax_pa=pa, jax_pb=pb,
                allgather=np.asarray(jax_scsr.make_allgather_csr_apply(
                    mesh, pa)(pa, sv)),
                banded=np.asarray(jax_scsr.make_banded_csr_apply(
                    mesh, pb)(pb, sv)))


@pytest.mark.parametrize("slots", SLOTS)
def test_csr_applies_match_jax(csr, slots):
    mesh = _mesh(slots)
    psi = torch.as_tensor(csr["psi"])
    pa = scsr.partition_csr_rows(csr["B"], slots)
    pb = scsr.partition_csr_banded(csr["A"], slots)
    if slots == 8:
        for mine, theirs in ((pa, csr["jax_pa"]), (pb, csr["jax_pb"])):
            carried = from_jax(theirs)
            assert type(carried) is type(mine)
            assert torch.equal(carried.col, mine.col)
            assert torch.equal(carried.data, mine.data)
        assert pb.halo == csr["jax_pb"].halo
    ga = scsr.make_allgather_csr_apply(mesh, pa)(pa, psi).numpy()
    gb = scsr.make_banded_csr_apply(mesh, pb)(pb, psi).numpy()
    assert _rel(ga, csr["allgather"]) < 1e-13
    assert _rel(gb, csr["banded"]) < 1e-13


def test_csr_banded_rejects_wide_band():
    A = random_banded(64, 30, np.random.default_rng(62))
    with pytest.raises(ValueError, match="halo|neighbor"):
        scsr.partition_csr_banded(A, 8)


# ---- BSR -------------------------------------------------------------------


@pytest.fixture(scope="module")
def bsr():
    rng = np.random.default_rng(4)
    R, b = 16, 4
    A = block_tridiag(R, b, rng)
    A = (0.5 * (A + A.conj().T)).tocsr()
    Ar = block_tridiag(R, b, rng, dtype=float)
    Ar = (0.5 * (Ar + Ar.T)).tocsr()
    N = R * b
    bound = max(float(np.abs(A).sum(axis=1).max()),
                float(np.abs(Ar).sum(axis=1).max()))
    e_min, delta = -bound, 2 * bound
    coeffs = cheby_coeffs(delta, DT)
    psi = _state(rng, N)
    far = A.tolil()
    far[0, N - 1] = far[N - 1, 0] = 0.3  # arbitrary sparsity
    far = far.tocsr()
    mesh = jax_mesh.chain_mesh(8)
    sv = jax_mesh.shard_vector(mesh, jnp.asarray(psi))
    pb = jax_sbsr.partition_bsr(A, 8, block_size=b)
    pg = jax_sbsr.partition_bsr(far, 8, block_size=b, mode="allgather")
    pdd = jax_sbsr.partition_bsr_dd(Ar, 8, block_size=b)
    step = jax_sbsr.make_sharded_bsr_cheby_step(
        mesh, pb, delta=delta, e_min=e_min, dt=DT)
    step_dd = jax_sbsr.make_sharded_bsr_cheby_step_dd(
        mesh, pdd, delta=delta, e_min=e_min, dt=DT)
    state4 = tuple(jax_mesh.shard_vector(mesh, jnp.asarray(p)) for p in
                   (*_dd_split(psi.real), *_dd_split(psi.imag)))
    rh, rl, ih, il = (np.asarray(p, np.float64) for p in step_dd(
        pdd, state4, *(jnp.asarray(c) for c in _dd_split(coeffs))))
    return dict(
        A=A, Ar=Ar, far=far, psi=psi, b=b, e_min=e_min, delta=delta,
        coeffs=coeffs, jax_pb=pb, jax_pdd=pdd,
        banded=np.asarray(jax_sbsr.make_banded_bsr_apply(mesh, pb)(pb, sv)),
        allgather=np.asarray(jax_sbsr.make_allgather_bsr_apply(
            mesh, pg)(pg, sv)),
        step=np.asarray(step(pb, sv, jnp.asarray(coeffs))),
        step_dd=(rh + rl) + 1j * (ih + il),
    )


@pytest.mark.parametrize("slots", SLOTS)
def test_bsr_applies_and_step_match_jax(bsr, slots):
    mesh = _mesh(slots)
    psi = torch.as_tensor(bsr["psi"])
    b = bsr["b"]
    pb = sbsr.partition_bsr(bsr["A"], slots, block_size=b)
    pg = sbsr.partition_bsr(bsr["far"], slots, block_size=b, mode="allgather")
    assert pb.halo_blocks == min(slots - 1, 1) and pg.halo_blocks == -1
    if slots == 8:
        carried = from_jax(bsr["jax_pb"])
        assert torch.equal(carried.cols, pb.cols)
        assert torch.equal(carried.blocks, pb.blocks)
    got = sbsr.make_banded_bsr_apply(mesh, pb)(pb, psi).numpy()
    assert _rel(got, bsr["banded"]) < 1e-13
    got = sbsr.make_allgather_bsr_apply(mesh, pg)(pg, psi).numpy()
    assert _rel(got, bsr["allgather"]) < 1e-13
    with pytest.raises(ValueError, match="all-gather"):
        sbsr.make_banded_bsr_apply(mesh, pg)
    step = sbsr.make_sharded_bsr_cheby_step(
        mesh, pb, delta=bsr["delta"], e_min=bsr["e_min"], dt=DT)
    got = step(pb, psi, bsr["coeffs"]).numpy()
    assert np.abs(got - bsr["step"]).max() < 1e-12


@pytest.mark.parametrize("slots", SLOTS)
def test_bsr_dd_apply_and_step(bsr, slots):
    """Float64 blocks, complex128 state: the apply against the f64
    matvec, the step against the JAX package's sharded double-float
    step and ``expm``; the partition against the JAX double-float one
    carried over."""
    mesh = _mesh(slots)
    Ar, b = bsr["Ar"], bsr["b"]
    pdd = sbsr.partition_bsr_dd(Ar, slots, block_size=b)
    if slots == 8:
        carried = from_jax(bsr["jax_pdd"])
        assert torch.equal(carried.cols, pdd.cols)
        # the JAX hi + lo pair holds each float64 entry to ~2^-48
        assert float((carried.blocks - pdd.blocks).abs().max()) < 1e-14
    x = torch.as_tensor(bsr["psi"])
    y = sbsr.banded_bsr_apply_dd(pdd, mesh.local(x), mesh=mesh).reshape(-1)
    assert _rel(y.numpy(), Ar @ bsr["psi"]) < 1e-13
    step = sbsr.make_sharded_bsr_cheby_step_dd(
        mesh, pdd, delta=bsr["delta"], e_min=bsr["e_min"], dt=DT)
    got = step(pdd, x, bsr["coeffs"]).numpy()
    assert np.abs(got - bsr["step_dd"]).max() < 1e-12
    want = scipy.linalg.expm(-1j * DT * Ar.toarray()) @ bsr["psi"]
    assert np.abs(got - want).max() < 1e-12


# ---- banded (band planes on banded_spmv) ------------------------------------


@pytest.fixture(scope="module")
def banded():
    rng = np.random.default_rng(17)
    N = 8 * 8 * 4  # 32 block rows of b = 8: R_local = 4 on 8 slots
    A = sp.diags(
        [rng.normal(size=N - 9), rng.normal(size=N - 1), rng.normal(size=N),
         rng.normal(size=N - 1), rng.normal(size=N - 9)],
        [-9, -1, 0, 1, 9],
    ).tocsr()
    A = (0.5 * (A + A.T)).tocsr()
    bound = float(np.abs(A).sum(axis=1).max())
    e_min, delta = -bound, 2 * bound
    psi = _state(np.random.default_rng(18), N)
    # the JAX package's unsharded step on the same operator
    want = np.asarray(jax_cheby_apply(
        qp.csr_from_scipy(A.astype(complex)), jnp.asarray(psi),
        jnp.asarray(cheby_coeffs(delta, 0.05)), delta, e_min, 0.05))
    return dict(A=A, N=N, rng=rng, e_min=e_min, delta=delta, psi=psi,
                step=want)


def test_partition_banded_layout_matches_jax(banded):
    A = banded["A"]
    pb = sbd.partition_banded_dd(A, 8, tile_rows=2, block=8)
    jpb = jax_sbd.partition_banded_dd(A, 8, tile_rows=2, block=8)
    assert pb.offsets == jpb.offsets == (-2, -1, 0, 1, 2)
    assert (pb.R_local, pb.n_devices, pb.b, pb.wb) == (4, 8, 8, 2)
    carried = from_jax(jpb)
    for f in ("planes", "edge_left", "edge_right"):
        mine, theirs = getattr(pb, f), getattr(carried, f)
        assert mine.shape == theirs.shape
        assert float((mine - theirs).abs().max()) < 1e-14
    with pytest.raises(ValueError, match="halo"):
        sbd.partition_banded_dd(A, 8, tile_rows=1, block=8)
    with pytest.raises(ValueError, match="divisible"):
        sbd.partition_banded_dd(A, 8, tile_rows=3, block=8)


@pytest.mark.parametrize("slots", SLOTS)
def test_sharded_banded_apply_at_shard_edges(banded, slots):
    """A random state and one living only on the block rows beside the
    slot edges: the clamped kernel on each slot's zeroed edge blocks
    plus the edge correction give ``A·x``."""
    A, N, rng = banded["A"], banded["N"], banded["rng"]
    mesh = _mesh(slots)
    pb = sbd.partition_banded_dd(A, slots, tile_rows=2, block=8)
    edge = np.zeros(N)
    n_slot = N // slots
    for s in range(slots):
        for o in (0, 8, n_slot - 16, n_slot - 8):
            edge[s * n_slot + o: s * n_slot + o + 8] = rng.normal(size=8)
    for x in (rng.normal(size=N) + 1j * rng.normal(size=N), edge + 0j):
        y = sbd.banded_pallas_apply_cdd(pb, mesh.local(torch.as_tensor(x)),
                                        mesh=mesh).reshape(-1)
        assert _rel(y.numpy(), A @ x) < 1e-13
    yr = sbd.banded_pallas_apply_dd(pb, mesh.local(torch.as_tensor(edge)),
                                    mesh=mesh)
    assert yr.dtype == torch.float64 and _rel(yr.reshape(-1).numpy(),
                                              A @ edge) < 1e-13


@pytest.mark.parametrize("slots", SLOTS)
def test_sharded_banded_step_and_factory(banded, slots):
    """The factory picks the banded path for the banded operator (its
    step against the JAX package's ``cheby_apply`` and ``expm`` to
    1e-12) and falls back to the blocked-ELL chain when a far coupling
    breaks the band."""
    A, N, psi = banded["A"], banded["N"], banded["psi"]
    e_min, delta = banded["e_min"], banded["delta"]
    mesh = _mesh(slots)
    coeffs = cheby_coeffs(delta, 0.05)
    kw = dict(delta=delta, e_min=e_min, dt=0.05, tile_rows=2, block_size=8)
    pb, step, kind = sbd.make_sharded_dd_cheby_step(mesh, A, slots, **kw)
    assert kind == "banded_pallas"
    assert isinstance(pb, sbd.PartitionedBandedDD)
    got = step(pb, torch.as_tensor(psi), coeffs).numpy()
    assert np.abs(got - banded["step"]).max() < 1e-12
    want = scipy.linalg.expm(-0.05j * A.toarray()) @ psi
    assert np.abs(got - want).max() < 1e-12
    far = A.tolil()
    far[0, N - 1] = far[N - 1, 0] = 0.3
    far = far.tocsr()
    pbdd, step, kind = sbd.make_sharded_dd_cheby_step(mesh, far, slots, **kw)
    assert kind == "bsr_xla" and isinstance(pbdd, sbsr.PartitionedBSRdd)
    got = step(pbdd, torch.as_tensor(psi), coeffs).numpy()
    want = scipy.linalg.expm(-0.05j * far.toarray()) @ psi
    assert np.abs(got - want).max() < 1e-12
