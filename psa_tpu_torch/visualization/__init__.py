"""SED visualization (matplotlib is imported when a figure is drawn)."""
from .sed_plotter import SEDPlotter
from .styles import DEFAULT_STYLE, COLOR_SCHEMES, apply_style, have_matplotlib

__all__ = ["SEDPlotter", "DEFAULT_STYLE", "COLOR_SCHEMES", "apply_style", "have_matplotlib"]
