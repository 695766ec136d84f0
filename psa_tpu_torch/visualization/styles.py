"""Plot styling presets and color schemes.

Same preset values and scheme names as the reference styling layer (reference:
src/psa/visualization/styles.py) — these constants ARE the behavioral spec —
with the schemes built from a compact color table.  Carried over from
:mod:`psa_tpu.visualization.styles`; matplotlib is imported by the function
that needs it, so the package imports where matplotlib is absent.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


def pyplot():
    """``matplotlib.pyplot``, imported on first use."""
    import matplotlib.pyplot as plt
    return plt


def have_matplotlib() -> bool:
    """Whether figures can be drawn here."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


# rcParams preset applied by apply_style (values per the reference spec).
DEFAULT_STYLE: Dict[str, Any] = dict(
    [('figure.figsize', (10, 8)), ('figure.dpi', 100), ('figure.autolayout', True),
     ('font.size', 12), ('axes.labelsize', 14), ('axes.titlesize', 16),
     ('xtick.labelsize', 12), ('ytick.labelsize', 12), ('legend.fontsize', 12),
     ('lines.linewidth', 2), ('lines.markersize', 6), ('image.cmap', 'viridis'),
     ('axes.grid', True), ('grid.alpha', 0.3), ('grid.linestyle', '--'),
     ('axes.spines.top', False), ('axes.spines.right', False)])

_SCHEME_ROLES = ('primary', 'secondary', 'tertiary', 'quaternary', 'background', 'grid')
_SCHEME_TABLE = {
    'default':    ('#1f77b4', '#ff7f0e', '#2ca02c', '#d62728', '#ffffff', '#cccccc'),
    'dark':       ('#4c72b0', '#dd8452', '#55a868', '#c44e52', '#2d2d2d', '#404040'),
    'scientific': ('#000000', '#e41a1c', '#377eb8', '#4daf4a', '#ffffff', '#dddddd'),
}

COLOR_SCHEMES: Dict[str, Dict[str, str]] = {
    name: dict(zip(_SCHEME_ROLES, colors)) for name, colors in _SCHEME_TABLE.items()
}


def apply_style(style: Optional[Dict[str, Any]] = None, color_scheme: str = 'default') -> None:
    """Apply DEFAULT_STYLE-shaped rcParams overlaid with a named color scheme."""
    if color_scheme not in COLOR_SCHEMES:
        raise ValueError(f"Unknown color scheme: {color_scheme}. "
                         f"Must be one of: {list(COLOR_SCHEMES.keys())}")
    colors = COLOR_SCHEMES[color_scheme]
    merged = dict(style or {})
    merged.update({
        'axes.facecolor': colors['background'],
        'figure.facecolor': colors['background'],
        'grid.color': colors['grid'],
        'axes.edgecolor': colors['primary'],
        'axes.labelcolor': colors['primary'],
        'xtick.color': colors['primary'],
        'ytick.color': colors['primary'],
        'text.color': colors['primary'],
    })
    pyplot().style.use(merged)


def get_colormap(name: str = 'viridis'):
    """Look up a matplotlib colormap by name."""
    return pyplot().get_cmap(name)


def get_color_cycle() -> list:
    """Colors of the active property cycle."""
    return pyplot().rcParams['axes.prop_cycle'].by_key()['color']


def set_color_cycle(colors: list) -> None:
    """Replace the active property cycle."""
    pyplot().rcParams['axes.prop_cycle'] = pyplot().cycler(color=colors)


def get_style_params() -> Dict[str, Any]:
    """Current values of the rcParams DEFAULT_STYLE manages."""
    return {k: v for k, v in pyplot().rcParams.items() if k in DEFAULT_STYLE}


def reset_style() -> None:
    """Back to matplotlib defaults."""
    pyplot().style.use('default')
