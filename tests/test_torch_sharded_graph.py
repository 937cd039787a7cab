"""The graphed sharded steps of ``quantumpropagators_torch.parallel`` on
the CPU (``utils/scan.graphed``, the port of the JAX package's
``jax.jit(shard_map(...))`` sites).

On the card each of the eight sites replays one CUDA graph a call; here
the wrapper is the body, so this file holds what a capture needs and
what the body computes:

- (a) one call of each site, after a warm-up call, runs under a guard
  that raises on every host read (``.item()``, ``.tolist()``,
  ``.numpy()``, ``float()``, ``bool()``, ``__array__``) and on
  ``torch.as_tensor``/``torch.tensor``/``torch.from_numpy`` of host
  data: on the card such a read cannot be captured;
- (b) each site against its JAX counterpart on the 8 virtual CPU
  devices, with the inputs and tolerances of ``test_torch_sharded_flip.py``
  and ``test_torch_sharded_sparse.py`` (max|Δ| < 1e-12 for the steps,
  relative 1e-13 for the applies), host and tensor coefficients, a
  scalar and a per-bit ``flip_scale``;
- (c) on the CPU the wrapper returns what the body returns and captures
  nothing.

The card's half (graph against eager bit for bit, captures) is
``test_torch_sharded_graph_cuda.py``."""

import numpy as np
import pytest
import torch

import quantumpropagators_torch as qt
from quantumpropagators.ops.cheby import cheby_coeffs
from quantumpropagators_torch.interop import from_jax
from quantumpropagators_torch.parallel import sharded_banded as sbd
from quantumpropagators_torch.parallel import sharded_bsr as sbsr
from quantumpropagators_torch.parallel import sharded_chain as sch
from quantumpropagators_torch.parallel import sharded_csr as scsr
from quantumpropagators_torch.parallel import sharded_fused as sf
from quantumpropagators_torch.parallel.mesh import chain_mesh
from quantumpropagators_torch.utils.scan import Graphed, _buffer, graphed
from test_torch_scan import HostRead, HostReadGuard
from test_torch_sharded_flip import DT, FS, G, L, jax_ref, problem
from test_torch_sharded_sparse import _rel, banded, bsr, chain, csr

qt.set_default_device("cpu")

SLOTS = 8  # the JAX package's 8 virtual CPU devices


class Guard(HostReadGuard):
    """:class:`HostReadGuard` plus ``torch.from_numpy``, which no
    ``TorchFunctionMode`` sees."""

    def __enter__(self):
        self._from_numpy = torch.from_numpy

        def refused(*args, **kwargs):
            raise HostRead("from_numpy")

        torch.from_numpy = refused
        return super().__enter__()

    def __exit__(self, *exc):
        torch.from_numpy = self._from_numpy
        return super().__exit__(*exc)


def test_guard_catches_from_numpy():
    with Guard(), pytest.raises(HostRead):
        torch.from_numpy(np.zeros(2))
    assert torch.from_numpy(np.zeros(2)).shape == (2,)


# -- the eight sites on the JAX tests' inputs --------------------------------

def _flip_sites(problem):
    diag, psi, e_min, delta = problem
    mesh = chain_mesh(SLOTS, device="cpu")
    coeffs = cheby_coeffs(delta, DT)
    beta = delta / 2 + e_min
    f32 = sf.make_sharded_fused_cheby_step(
        mesh, L, G, delta=delta, e_min=e_min, dt=DT, tile_rows=8)
    dd = sf.make_sharded_fused_cheby_step_dd(mesh, L, G, delta=delta,
                                             e_min=e_min, dt=DT)
    f64 = torch.float64
    d, p = torch.as_tensor(diag), torch.as_tensor(psi)
    re, im = torch.as_tensor(psi.real), torch.as_tensor(psi.imag)
    dmb = torch.as_tensor(diag - beta)
    return {
        "f32 float": (f32, (d, re, im, coeffs), {"flip_scale": 0.65}),
        "f32 0-d tensor": (f32, (d, re, im, coeffs),
                           {"flip_scale": torch.tensor(0.65, dtype=f64)}),
        "dd float": (dd, (dmb, p, coeffs), {"flip_scale": FS}),
        "dd 0-d tensor": (dd, (dmb, p, coeffs),
                          {"flip_scale": torch.tensor(FS, dtype=f64)}),
        "dd per-bit tensor": (dd, (dmb, p, coeffs),
                              {"flip_scale": torch.full((L,), FS,
                                                        dtype=f64)}),
        "dd per-bit host": (dd, (dmb, p, coeffs),
                            {"flip_scale": np.full(L, FS)}),
    }


def _sparse_sites(chain, csr, bsr, banded):
    mesh = chain_mesh(SLOTS, device="cpu")
    sites = {}
    op = sch.prepare_sharded_operator(from_jax(chain["op"]), SLOTS,
                                      group_bits=4)
    step = sch.make_sharded_cheby_step(mesh, op, delta=chain["delta"],
                                       e_min=chain["e_min"], dt=0.1)
    p = torch.as_tensor(chain["psi"])
    for how, c in (("host", chain["coeffs"]),
                   ("tensor", torch.as_tensor(chain["coeffs"]))):
        sites[f"chain step {how}"] = (step, (op, p, c), {})
    p = torch.as_tensor(csr["psi"])
    pa = scsr.partition_csr_rows(csr["B"], SLOTS)
    pc = scsr.partition_csr_banded(csr["A"], SLOTS)
    sites["CSR all-gather apply"] = (scsr.make_allgather_csr_apply(mesh, pa),
                                     (pa, p), {})
    sites["CSR halo apply"] = (scsr.make_banded_csr_apply(mesh, pc), (pc, p),
                               {})
    b, p = bsr["b"], torch.as_tensor(bsr["psi"])
    pb = sbsr.partition_bsr(bsr["A"], SLOTS, block_size=b)
    pg = sbsr.partition_bsr(bsr["far"], SLOTS, block_size=b,
                            mode="allgather")
    pdd = sbsr.partition_bsr_dd(bsr["Ar"], SLOTS, block_size=b)
    sites["BSR halo apply"] = (sbsr.make_banded_bsr_apply(mesh, pb), (pb, p),
                               {})
    sites["BSR all-gather apply"] = (sbsr.make_allgather_bsr_apply(mesh, pg),
                                     (pg, p), {})
    kw = dict(delta=bsr["delta"], e_min=bsr["e_min"], dt=0.1)
    step = sbsr.make_sharded_bsr_cheby_step(mesh, pb, **kw)
    step_dd = sbsr.make_sharded_bsr_cheby_step_dd(mesh, pdd, **kw)
    for how, c in (("host", bsr["coeffs"]),
                   ("tensor", torch.as_tensor(bsr["coeffs"]))):
        sites[f"BSR step {how}"] = (step, (pb, p, c), {})
        sites[f"BSR dd step {how}"] = (step_dd, (pdd, p, c), {})
    pbd, step, kind = sbd.make_sharded_dd_cheby_step(
        mesh, banded["A"], SLOTS, delta=banded["delta"],
        e_min=banded["e_min"], dt=0.05, tile_rows=2, block_size=8)
    assert kind == "banded_pallas"
    c = cheby_coeffs(banded["delta"], 0.05)
    p = torch.as_tensor(banded["psi"])
    sites["banded step host"] = (step, (pbd, p, c), {})
    sites["banded step tensor"] = (step, (pbd, p, torch.as_tensor(c)), {})
    return sites


# (site, what the JAX package computes, tolerance, relative)
FLIP_CASES = {
    "f32 float": ("f32_0.65", 1e-12), "f32 0-d tensor": ("f32_0.65", 1e-12),
    "dd float": (f"dd_{FS}", 1e-12), "dd 0-d tensor": (f"dd_{FS}", 1e-12),
    "dd per-bit tensor": (f"dd_{FS}", 1e-12),
    "dd per-bit host": (f"dd_{FS}", 1e-12),
}
SPARSE_CASES = {
    "chain step host": ("chain", "step", 1e-12, False),
    "chain step tensor": ("chain", "step", 1e-12, False),
    "CSR all-gather apply": ("csr", "allgather", 1e-13, True),
    "CSR halo apply": ("csr", "banded", 1e-13, True),
    "BSR halo apply": ("bsr", "banded", 1e-13, True),
    "BSR all-gather apply": ("bsr", "allgather", 1e-13, True),
    "BSR step host": ("bsr", "step", 1e-12, False),
    "BSR step tensor": ("bsr", "step", 1e-12, False),
    "BSR dd step host": ("bsr", "step_dd", 1e-12, False),
    "BSR dd step tensor": ("bsr", "step_dd", 1e-12, False),
    "banded step host": ("banded", "step", 1e-12, False),
    "banded step tensor": ("banded", "step", 1e-12, False),
}


@pytest.fixture(scope="module")
def flip_sites(problem):
    return _flip_sites(problem)


@pytest.fixture(scope="module")
def sparse_sites(chain, csr, bsr, banded):
    return _sparse_sites(chain, csr, bsr, banded)


def _result(out):
    if isinstance(out, tuple):  # the f32 step's (re, im)
        return out[0].numpy() + 1j * out[1].numpy()
    return out.numpy()


# -- (a) a captured call reads nothing from the host -------------------------

def _captured_call(step, args, kwargs):
    """The body's call as the capture makes it: a Python-number or host
    array control arrives as the graph's buffer (a tensor)."""
    kwargs = {k: v if k not in step.controls or isinstance(v, torch.Tensor)
              or v is None else _buffer(v, torch.device("cpu"))
              for k, v in kwargs.items()}
    warm = step.body(*args, **kwargs)  # builds the plan's device constants
    with Guard():
        out = step.body(*args, **kwargs)
    assert np.array_equal(_result(out), _result(warm))


@pytest.mark.parametrize("site", sorted(FLIP_CASES))
def test_flip_site_reads_nothing_from_the_host(flip_sites, site):
    _captured_call(*flip_sites[site])


@pytest.mark.parametrize("site", sorted(SPARSE_CASES))
def test_sparse_site_reads_nothing_from_the_host(sparse_sites, site):
    _captured_call(*sparse_sites[site])


# -- (b) against the JAX package ----------------------------------------------

@pytest.mark.parametrize("site", sorted(FLIP_CASES))
def test_flip_site_matches_jax(flip_sites, jax_ref, site):
    step, args, kwargs = flip_sites[site]
    key, tol = FLIP_CASES[site]
    assert np.abs(_result(step(*args, **kwargs)) - jax_ref[key]).max() < tol


@pytest.mark.parametrize("site", sorted(SPARSE_CASES))
def test_sparse_site_matches_jax(sparse_sites, chain, csr, bsr, banded,
                                 site):
    step, args, kwargs = sparse_sites[site]
    fixture, key, tol, relative = SPARSE_CASES[site]
    want = dict(chain=chain, csr=csr, bsr=bsr, banded=banded)[fixture][key]
    got = _result(step(*args, **kwargs))
    err = _rel(got, want) if relative else np.abs(got - want).max()
    assert err < tol


# -- (c) on the CPU the wrapper is the body -----------------------------------

def test_every_site_is_graphed_and_the_body_on_the_cpu(flip_sites,
                                                        sparse_sites):
    for name, (step, args, kwargs) in {**flip_sites, **sparse_sites}.items():
        assert isinstance(step, Graphed), name
        got, want = step(*args, **kwargs), step.body(*args, **kwargs)
        assert np.array_equal(_result(got), _result(want)), name
        assert step.captures == 0, name


def test_dd_step_keeps_its_exchange_plan_and_errors(flip_sites):
    step, args, _ = flip_sites["dd float"]
    assert step.exchange_plan["device_bits"] == 3
    with pytest.raises(ValueError, match="per-bit flip_scale"):
        step(*args, flip_scale=np.ones(L - 1))


def test_key_reads_operators_in_place_and_host_values_by_value():
    """The graph's key: a control's kind, not its value; a host
    coefficient array by value; an operator's host tensors by value."""
    g = graphed(lambda op, x, c, s=1.0: x, operators=("op",),
                controls=("s",))
    c = np.arange(3.0)
    k1, in1 = g._key({"op": (torch.ones(2),), "x": 1, "c": c, "s": 0.5})
    k2, in2 = g._key({"op": (torch.ones(2),), "x": 1, "c": c.copy(),
                      "s": 0.7})
    assert k1 == k2 and in1 == [("s", 0.5)] and in2 == [("s", 0.7)]
    k3, _ = g._key({"op": (torch.ones(2),), "x": 1, "c": c + 1, "s": 0.5})
    k4, _ = g._key({"op": (torch.zeros(2),), "x": 1, "c": c, "s": 0.5})
    k5, in5 = g._key({"op": (torch.ones(2),), "x": 1, "c": c,
                      "s": np.ones(2)})
    assert len({k1, k3, k4, k5}) == 4
    assert in5[0][0] == "s" and np.array_equal(in5[0][1], np.ones(2))
