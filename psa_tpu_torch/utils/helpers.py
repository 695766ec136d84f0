"""General helpers: direction parsing, dict merging, small validation utilities.

Behavioral parity with the reference implementation's utility layer
(reference: src/psa/utils/helpers.py:13-172), re-implemented from its observable
contract.  These run host-side (NumPy) — they shape tiny metadata, not the hot path.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Tuple, Union

import numpy as np

logger = logging.getLogger(__name__)

DirectionSpec = Union[str, int, float, List[float], Tuple[float, ...], np.ndarray, Dict[str, float]]

# Canonical named directions (unit vectors).  Covers Cartesian axes, face/body
# diagonals and the common cubic Miller strings (reference: helpers.py:39-51).
_SQ2 = 1.0 / np.sqrt(2.0)
_SQ3 = 1.0 / np.sqrt(3.0)
_NAMED_DIRECTIONS: Dict[str, List[float]] = {
    'x': [1, 0, 0], 'y': [0, 1, 0], 'z': [0, 0, 1],
    'xy': [_SQ2, _SQ2, 0], 'yx': [_SQ2, _SQ2, 0],
    'xz': [_SQ2, 0, _SQ2], 'zx': [_SQ2, 0, _SQ2],
    'yz': [0, _SQ2, _SQ2], 'zy': [0, _SQ2, _SQ2],
    'xyz': [_SQ3, _SQ3, _SQ3],
    '100': [1, 0, 0], '010': [0, 1, 0], '001': [0, 0, 1],
    '110': [_SQ2, _SQ2, 0],
    '111': [_SQ3, _SQ3, _SQ3],
}


def _from_angle_deg(angle_deg: float) -> np.ndarray:
    rad = np.deg2rad(float(angle_deg))
    return np.array([np.cos(rad), np.sin(rad), 0.0], dtype=np.float32)


def parse_direction(direction_spec: DirectionSpec) -> np.ndarray:
    """Parse a direction specification into a normalized 3D float32 vector.

    Accepted forms (reference: helpers.py:13-109):
      * number (int/float)          -> angle in degrees in the XY plane
      * string name                 -> 'x','y','z','xy','yz','xz','xyz','100','110','111',...
      * numeric string              -> angle in degrees ("45")
      * CSV / whitespace triple     -> "1,0,0" or "1 0 0"
      * list/tuple/array            -> 1 element = angle; 3 elements = vector;
                                       0-d array = angle
      * dict                        -> {'angle': deg} or Miller {'h','k','l'}

    Raises ValueError for zero vectors and malformed inputs, TypeError for
    unsupported types.
    """
    if isinstance(direction_spec, (int, float)) and not isinstance(direction_spec, bool):
        vec = _from_angle_deg(direction_spec)

    elif isinstance(direction_spec, str):
        d_lower = direction_spec.lower()
        if d_lower in _NAMED_DIRECTIONS:
            vec = np.array(_NAMED_DIRECTIONS[d_lower], dtype=np.float32)
        else:
            try:
                vec = _from_angle_deg(float(direction_spec))
            except ValueError:
                parts = direction_spec.replace(',', ' ').split()
                if len(parts) == 3:
                    try:
                        vec = np.array([float(p) for p in parts], dtype=np.float32)
                    except ValueError:
                        raise ValueError(f"Unknown direction string: {direction_spec}.")
                else:
                    raise ValueError(f"Unknown direction string: {direction_spec}.")

    elif isinstance(direction_spec, (list, tuple, np.ndarray)):
        d_arr = np.asarray(direction_spec, dtype=np.float32).squeeze()
        if d_arr.ndim == 0:
            vec = _from_angle_deg(d_arr.item())
        elif d_arr.ndim == 1:
            if d_arr.size == 1:
                vec = _from_angle_deg(d_arr[0])
            elif d_arr.size == 3:
                vec = d_arr
            else:
                raise ValueError(
                    f"Direction array must have 1 (angle) or 3 (vector) components, got {d_arr.size}")
        else:
            raise ValueError(
                f"Direction array has too many dims: {d_arr.ndim}, expected 0 or 1 (squeezed).")

    elif isinstance(direction_spec, dict):
        if 'angle' in direction_spec:
            vec = _from_angle_deg(float(direction_spec['angle']))
        elif any(k in direction_spec for k in ('h', 'k', 'l')):
            vec = np.array([
                float(direction_spec.get('h', 0.0)),
                float(direction_spec.get('k', 0.0)),
                float(direction_spec.get('l', 0.0)),
            ], dtype=np.float32)
        else:
            raise ValueError("Direction dict needs an 'angle' key or the Miller "
                             "triple 'h'/'k'/'l'.")
    else:
        raise TypeError(f"Unsupported direction type: {type(direction_spec)}")

    if np.allclose(vec, 0, atol=1e-8):
        raise ValueError("Direction resolves to the zero vector — a k-path "
                         "needs a non-zero direction.")

    norm_val = np.linalg.norm(vec)
    if norm_val < 1e-9:
        # Pathological but non-"allclose-zero" norm: pass the raw vector through
        # rather than dividing by ~0 (reference: helpers.py:104-107).
        logger.warning("Direction nearly zero (|v| = %.2e); skipping normalization.",
                       norm_val)
        return vec
    return (vec / norm_val).astype(np.float32)


# Named directions as INTEGER Miller vectors (unnormalized) — the NPT
# family sweeps fractional Miller space, where m = [1,1,0] is a
# box-commensurate mode but the unit vector [0.707, 0.707, 0] is not.
_NAMED_MILLER: Dict[str, List[int]] = {
    'x': [1, 0, 0], 'y': [0, 1, 0], 'z': [0, 0, 1],
    'xy': [1, 1, 0], 'yx': [1, 1, 0],
    'xz': [1, 0, 1], 'zx': [1, 0, 1],
    'yz': [0, 1, 1], 'zy': [0, 1, 1],
    'xyz': [1, 1, 1],
    '100': [1, 0, 0], '010': [0, 1, 0], '001': [0, 0, 1],
    '110': [1, 1, 0], '111': [1, 1, 1],
}


def parse_miller_direction(direction_spec: DirectionSpec) -> np.ndarray:
    """Direction spec -> UNNORMALIZED Miller vector, float64 (3,).

    The NPT-family analog of :func:`parse_direction`: named directions map
    to their integer Miller vectors ('xy' -> [1,1,0], not [0.707, ...]),
    and explicit vectors / Miller dicts pass through RAW — so integer
    multiples of the direction stay box-commensurate, matching the CLI
    ``npt.direction`` semantics.  Angle forms (no integer Miller analog)
    fall back to the unit vector of :func:`parse_direction`.
    """
    if isinstance(direction_spec, str):
        name = direction_spec.lower()
        if name in _NAMED_MILLER:
            return np.asarray(_NAMED_MILLER[name], dtype=np.float64)
        parts = direction_spec.replace(',', ' ').split()
        if len(parts) == 3:
            try:
                vec = np.array([float(p) for p in parts], dtype=np.float64)
            except ValueError:
                vec = None
            if vec is not None:
                if np.allclose(vec, 0, atol=1e-12):
                    raise ValueError("Direction resolves to the zero "
                                     "vector.")
                return vec
    elif isinstance(direction_spec, (list, tuple, np.ndarray)):
        arr = np.asarray(direction_spec, dtype=np.float64).squeeze()
        if arr.ndim == 1 and arr.size == 3:
            if np.allclose(arr, 0, atol=1e-12):
                raise ValueError("Direction resolves to the zero vector.")
            return arr
    elif isinstance(direction_spec, dict) and any(
            k in direction_spec for k in ('h', 'k', 'l')):
        vec = np.array([float(direction_spec.get(c, 0.0))
                        for c in ('h', 'k', 'l')], dtype=np.float64)
        if np.allclose(vec, 0, atol=1e-12):
            raise ValueError("Direction resolves to the zero vector.")
        return vec
    return parse_direction(direction_spec).astype(np.float64)


def miller_line(direction: DirectionSpec, n_k: int,
                max_order: float) -> np.ndarray:
    """(n_k, 3) Miller rows d·(max_order/n_k .. max_order) — the ONE
    construction of the NPT k-path, shared by the CLI section, the GUI
    controller, and iSED so the three surfaces cannot diverge."""
    n_k = int(n_k)
    if n_k < 1:
        raise ValueError(f"n_k must be >= 1, got {n_k}")
    if not np.isfinite(max_order) or max_order <= 0:
        raise ValueError(f"max_order must be > 0, got {max_order!r}")
    d = parse_miller_direction(direction)
    return d[None, :] * np.linspace(max_order / n_k, max_order,
                                    n_k)[:, None]


def direction_label(direction_spec: DirectionSpec, index: int = 0) -> str:
    """Filesystem-safe label for a direction spec (used in cache/plot filenames).

    Mirrors the labeling scheme of the reference CLI (cli.py:108-112).
    """
    if isinstance(direction_spec, (int, float)) and not isinstance(direction_spec, bool):
        return f"{float(direction_spec):.1f}deg"
    if isinstance(direction_spec, str):
        return direction_spec.replace(" ", "_").replace("/", "-")
    if isinstance(direction_spec, (list, tuple, np.ndarray)):
        arr = np.asarray(direction_spec)
        if arr.size == 1:
            return f"{arr.item():.1f}deg"
        return '_'.join(f"{x:.2f}" for x in arr)
    if isinstance(direction_spec, dict):
        return (f"h{direction_spec.get('h', 0)}_k{direction_spec.get('k', 0)}"
                f"_l{direction_spec.get('l', 0)}")
    return f"dir{index}"


def update_dict_recursively(base_dict: dict, update_with: dict) -> dict:
    """Recursively overlay ``update_with`` onto ``base_dict`` in place and return it."""
    for k, v_update in update_with.items():
        if isinstance(v_update, dict) and k in base_dict and isinstance(base_dict[k], dict):
            update_dict_recursively(base_dict[k], v_update)
        else:
            base_dict[k] = v_update
    return base_dict


def ensure_directory(path: Union[str, Path]) -> Path:
    """Create ``path`` (and parents) if needed; return it as a Path."""
    dir_path = Path(path)
    dir_path.mkdir(parents=True, exist_ok=True)
    return dir_path


def validate_array_shape(arr: np.ndarray, expected_shape: tuple, name: str) -> None:
    """Raise ValueError if ``arr.shape != expected_shape``."""
    if arr.shape != expected_shape:
        raise ValueError(f"{name} has shape {arr.shape}, expected {expected_shape}")


def safe_divide(a: np.ndarray, b: np.ndarray, fill_value: float = 0.0) -> np.ndarray:
    """Elementwise a/b with ``fill_value`` wherever b == 0."""
    with np.errstate(divide='ignore', invalid='ignore'):
        result = np.divide(a, b, out=np.full_like(a, fill_value), where=b != 0)
    return result
