"""Interface-contract checking layer (reference ``src/interfaces/``)."""

from .checks import (
    check_amplitude,
    check_control,
    check_generator,
    check_operator,
    check_state,
    check_state_vector_interface,
    check_tlist,
)

__all__ = [
    "check_tlist",
    "check_state",
    "check_state_vector_interface",
    "check_operator",
    "check_generator",
    "check_amplitude",
    "check_control",
]
