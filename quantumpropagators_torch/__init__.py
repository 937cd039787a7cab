"""quantumpropagators_torch — the PyTorch/CUDA port of
:mod:`quantumpropagators`.

Same public names and semantics as the JAX package, on torch tensors:
controls, amplitudes, CRAB functions and pulse shapes, the operator /
generator algebra, lattice operators, the propagation methods
``cheby``, ``newton``, ``krylov``/``expv``, ``expprop`` and ``ode``
(stepwise through ``propagate``), whole-grid Chebyshev and fixed-Leja
Newton propagation (``propagate(..., fused=True)``), storage, the
contract checks (``check_*``, also behind ``check=True``) and sharding
(:mod:`.parallel`).  ``precision="dd"`` and ``kernel="dd"`` keep the
JAX package's names for its reference-accuracy tier, which is
complex128 here.  The TPU Pallas kernels are hand-written CUDA kernels
for Hopper (``csrc/cheby_flip.cu`` for diagonal-plus-site-flip
generators, ``csrc/banded_spmv.cu`` for block-banded operators, the
product the Krylov methods also run), built with ``nvcc`` at first
use; on CPU tensors their plain PyTorch versions run instead.

Tensors are built on the package's default device, ``cuda``, unless
the caller names one; ``set_default_device("cpu")`` makes the CPU the
default.

This package imports ``torch`` and never ``jax``.  Objects built with
the JAX package are carried over with :func:`interop.from_jax`.
"""

from .models.controls import (
    ParameterizedFunction,
    ParameterPartition,
    discretize,
    discretize_on_midpoints,
    evaluate,
    get_controls,
    get_parameters,
    get_tlist_midpoints,
    substitute,
    t_mid,
)
from .models.generators import (
    Generator,
    Operator,
    ScaledOperator,
    coeff_table,
    hamiltonian,
    liouvillian,
)
from .models.shapes import blackman, box, flattop
from .models.amplitudes import GuidedAmplitude, LockedAmplitude, ShapedAmplitude
from .models.crab import (
    CRABFunction,
    VariedFrequencyCRABFunction,
    crab_initial_parameters,
)
from .models.lattice import (
    GroupedSiteSum,
    SiteOperatorSum,
    transverse_field_ising,
    transverse_field_ising_2d,
)
from .ops.operators import (
    BSROperator,
    CSROperator,
    DIAOperator,
    DiagonalOperator,
    StackedCSROperator,
    apply,
    bsr_from_dense,
    bsr_from_scipy,
    choose_block_size,
    csr_from_dense,
    csr_from_scipy,
    default_device,
    dia_from_scipy,
    op_dot,
    set_default_device,
    to_dense,
)
from .ops.specrange import specrange
from .utils.iddict import IdDict
from .interfaces import (
    check_amplitude,
    check_control,
    check_generator,
    check_operator,
    check_parameterized,
    check_parameterized_function,
    check_propagator,
    check_state,
    check_state_vector_interface,
    check_tlist,
    supports_inplace,
    supports_matrix_interface,
    supports_vector_interface,
)
from .interop import from_jax, to_numpy

__version__ = "0.1.0"

# Propagator layer (imported late to avoid cycles)
from .propagators import init_prop, prop_step, reinit_prop, set_state, set_t  # noqa: E402
from .propagate import propagate, propagate_sequence, Propagation  # noqa: E402
from .storage import init_storage, map_observables, write_to_storage, get_from_storage  # noqa: E402

__all__ = [
    # controls
    "discretize",
    "discretize_on_midpoints",
    "get_tlist_midpoints",
    "t_mid",
    "evaluate",
    "get_controls",
    "get_parameters",
    "substitute",
    "ParameterizedFunction",
    "ParameterPartition",
    "IdDict",
    # shapes
    "flattop",
    "box",
    "blackman",
    # amplitudes & parameterized functions
    "LockedAmplitude",
    "ShapedAmplitude",
    "GuidedAmplitude",
    "CRABFunction",
    "VariedFrequencyCRABFunction",
    "crab_initial_parameters",
    # lattice models
    "SiteOperatorSum",
    "GroupedSiteSum",
    "transverse_field_ising",
    "transverse_field_ising_2d",
    # generators
    "Generator",
    "Operator",
    "ScaledOperator",
    "hamiltonian",
    "liouvillian",
    "coeff_table",
    # operators
    "CSROperator",
    "DIAOperator",
    "dia_from_scipy",
    "BSROperator",
    "bsr_from_scipy",
    "bsr_from_dense",
    "choose_block_size",
    "DiagonalOperator",
    "StackedCSROperator",
    "apply",
    "op_dot",
    "to_dense",
    "csr_from_dense",
    "csr_from_scipy",
    # methods
    "specrange",
    # interface checks
    "check_tlist",
    "check_state",
    "check_state_vector_interface",
    "check_operator",
    "check_generator",
    "check_amplitude",
    "check_control",
    "check_propagator",
    "check_parameterized_function",
    "check_parameterized",
    "supports_inplace",
    "supports_vector_interface",
    "supports_matrix_interface",
    # propagation
    "init_prop",
    "prop_step",
    "reinit_prop",
    "set_state",
    "set_t",
    "propagate",
    "propagate_sequence",
    "Propagation",
    "init_storage",
    "map_observables",
    "write_to_storage",
    "get_from_storage",
    # devices
    "default_device",
    "set_default_device",
    # interop
    "from_jax",
    "to_numpy",
]
