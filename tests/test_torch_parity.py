"""Every public name of the JAX package has a counterpart in the port.

The public ``def``/``class`` names at the top level of each
``quantumpropagators/**/*.py`` are read with ``ast`` (nothing of the
JAX package is imported for the walk).  Each must be an attribute of
the port's module at the same path, or have an entry in
:data:`MAPPED`: the port object that does its work, or ``None`` where
no object is needed, and the reason.  One case per JAX module."""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "quantumpropagators"

_DD = ("the port's reference-accuracy tier is native complex128 (ROADMAP "
       "port conventions, Precision), so the double-word f32 arithmetic "
       "is one complex128 operation")
_PALLAS = ("the banded Pallas module's names live in ops/bsr_dd.py (band "
           "planes, the step) and ops/banded_spmv.py (the CUDA kernel's "
           "wrapper)")
_CONFIG = ("config.py sets JAX's x64 flag and detects a TPU; the port is "
           "complex128 natively and names its device with "
           "set_default_device / default_device")

# name -> (dotted path of the port counterpart or None, reason)
MAPPED = {
    "config.use_cpu_x64": ("quantumpropagators_torch.set_default_device",
                           _CONFIG),
    "config.x64_enabled": (None, _CONFIG + "; complex128 is always on"),
    "config.default_real_dtype": ("torch.float64", _CONFIG),
    "config.default_complex_dtype": ("torch.complex128", _CONFIG),
    "config.on_tpu": ("quantumpropagators_torch.default_device", _CONFIG),
    "ops.df64.two_sum": ("torch.add", _DD),
    "ops.df64.dd_add": ("torch.add", _DD),
    "ops.df64.dd_neg": ("torch.neg", _DD),
    "ops.df64.dd_sub": ("torch.sub", _DD),
    "ops.df64.dd_mul": ("torch.mul", _DD),
    "ops.df64.dd_scale": ("torch.mul", _DD),
    "ops.df64.cdd_add": ("torch.add", _DD),
    "ops.df64.cdd_scale": ("torch.mul", _DD),
    "ops.df64.validate_df64": (None, _DD + "; FP64 needs no emulation "
                                           "check"),
    "ops.df64_sparse.bsr_blocks_apply_dd": (
        "quantumpropagators_torch.ops.df64_sparse.bsr_apply_dd", _DD),
    "ops.bsr_dd_pallas.BandedDD": (
        "quantumpropagators_torch.ops.bsr_dd.BandedDD", _PALLAS),
    "ops.bsr_dd_pallas.banded_dd_from_scipy": (
        "quantumpropagators_torch.ops.bsr_dd.banded_dd_from_scipy", _PALLAS),
    "ops.bsr_dd_pallas.banded_dd_apply": (
        "quantumpropagators_torch.ops.banded_spmv.banded_dd_apply", _PALLAS),
    "ops.bsr_dd_pallas.banded_dd_apply_extended": (
        "quantumpropagators_torch.ops.banded_spmv.banded_dd_apply_extended",
        _PALLAS),
    "ops.bsr_dd_pallas.cheby_apply_dd_banded": (
        "quantumpropagators_torch.ops.bsr_dd.cheby_apply_dd_banded",
        _PALLAS),
}

MODULES = sorted(
    ".".join(p.relative_to(JAX_PKG).with_suffix("").parts)
    for p in JAX_PKG.rglob("*.py")
)


def _public_names(module: str):
    path = JAX_PKG.joinpath(*module.split(".")).with_suffix(".py")
    tree = ast.parse(path.read_text())
    return [node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef))
            and not node.name.startswith("_")]


def _port_module(module: str):
    name = "quantumpropagators_torch." + module.removesuffix("__init__")
    try:
        return importlib.import_module(name.rstrip("."))
    except ModuleNotFoundError:
        return None


def _resolve(dotted: str):
    parts = dotted.split(".")
    for cut in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:cut]))
        except ModuleNotFoundError:
            continue
        for attr in parts[cut:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


@pytest.mark.parametrize("module", MODULES)
def test_public_names_have_port_counterparts(module):
    port = _port_module(module)
    for name in _public_names(module):
        key = f"{module}.{name}"
        if port is not None and hasattr(port, name):
            assert key not in MAPPED, f"{key} is ported: drop its entry"
            continue
        assert key in MAPPED, f"{key} has no port counterpart"
        target, reason = MAPPED[key]
        assert reason
        if target is not None:
            assert _resolve(target) is not None


def test_mapped_names_exist_in_the_jax_package():
    for key in MAPPED:
        module, name = key.rsplit(".", 1)
        assert module in MODULES and name in _public_names(module), key


# Every pl.pallas_call in the repo (the package and the TPU probes under
# docs/profiling/) maps to a named Hopper kernel: the kernels line of
# chip_smoke.py names the site(s) each kernel replaces.
PALLAS_ROOTS = (JAX_PKG, ROOT / "docs" / "profiling")


def _pallas_sites():
    sites = []
    for top in PALLAS_ROOTS:
        for path in sorted(top.rglob("*.py")):
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "pallas_call":
                    sites.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    return sorted(sites)


def _hopper_kernels():
    """site -> the Hopper kernels that replace it."""
    import chip_smoke
    from quantumpropagators_torch.ops import probes

    tables = [chip_smoke.REPLACES, chip_smoke.ALSO_REPLACES,
              {chip_smoke.BANDED: chip_smoke.BANDED_REPLACES},
              probes.REPLACES]
    out = {}
    for table in tables:
        for kernel, sites in table.items():
            for site in sites.split(", "):
                out.setdefault(site, set()).add(kernel)
    return out


PALLAS_SITES = _pallas_sites()


@pytest.mark.parametrize("site", PALLAS_SITES)
def test_pallas_call_has_a_hopper_kernel(site):
    from quantumpropagators_torch.ops import banded_spmv, cheby_flip, probes

    kernels = _hopper_kernels().get(site)
    assert kernels, f"{site}: no Hopper kernel replaces this pl.pallas_call"
    counted = set(cheby_flip.LAUNCHES) | set(banded_spmv.LAUNCHES) \
        | set(probes.LAUNCHES)
    assert kernels <= counted, kernels - counted


def test_replaced_sites_are_pallas_calls():
    assert len(PALLAS_SITES) >= 24  # the walk finds the known sites
    assert set(_hopper_kernels()) <= set(PALLAS_SITES)
