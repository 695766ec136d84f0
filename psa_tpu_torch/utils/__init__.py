"""Utilities: direction parsing, config management, relaxation fits, misc helpers."""
from .fits import isf_relaxation_time, kww_fit
from .helpers import (
    parse_direction, update_dict_recursively, ensure_directory,
    validate_array_shape, safe_divide, direction_label,
)

__all__ = [
    "parse_direction", "update_dict_recursively", "ensure_directory",
    "validate_array_shape", "safe_divide", "direction_label",
    "isf_relaxation_time", "kww_fit",
]
