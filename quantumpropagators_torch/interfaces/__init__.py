"""Interface-contract checking layer (reference ``src/interfaces/``)."""

from .checks import (
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

__all__ = [
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
]
