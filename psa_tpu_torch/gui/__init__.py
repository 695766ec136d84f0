"""Interactive workflow: the headless controller and exports, and the Tk view.

``controller`` and ``export`` import neither Tk nor matplotlib (nor pandas
nor imageio) and run where there is no display; ``app`` and ``widgets`` are
the Tkinter view and import both at module top.  This package imports none
of them by itself.
"""
