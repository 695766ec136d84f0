"""Reusable Tk widgets: tooltips, progress dialog, labeled-entry factories.

Carried over from :mod:`psa_tpu.gui.widgets`: Tk only, no array library
(reference: src/psa/gui/psa_gui.py:51-137, 175-204, 2999-3018).
"""
from __future__ import annotations

import tkinter as tk
from tkinter import ttk


class ToolTip:
    """Hover tooltip for any widget."""

    def __init__(self, widget, text: str, delay_ms: int = 500):
        self.widget = widget
        self.text = text
        self.delay_ms = delay_ms
        self._after_id = None
        self._tip = None
        widget.bind('<Enter>', self._schedule)
        widget.bind('<Leave>', self._hide)
        widget.bind('<ButtonPress>', self._hide)

    def _schedule(self, _event=None):
        self._cancel()
        self._after_id = self.widget.after(self.delay_ms, self._show)

    def _cancel(self):
        if self._after_id is not None:
            self.widget.after_cancel(self._after_id)
            self._after_id = None

    def _show(self):
        if self._tip is not None:
            return
        x = self.widget.winfo_rootx() + 20
        y = self.widget.winfo_rooty() + self.widget.winfo_height() + 4
        self._tip = tk.Toplevel(self.widget)
        self._tip.wm_overrideredirect(True)
        self._tip.wm_geometry(f"+{x}+{y}")
        label = tk.Label(self._tip, text=self.text, justify='left',
                         background='#ffffe0', relief='solid', borderwidth=1,
                         font=('TkDefaultFont', 9), wraplength=360)
        label.pack(ipadx=4, ipady=2)

    def _hide(self, _event=None):
        self._cancel()
        if self._tip is not None:
            self._tip.destroy()
            self._tip = None


class ProgressDialog:
    """Modal indeterminate progress window for long operations."""

    def __init__(self, parent, title: str = "Working...", message: str = ""):
        self.top = tk.Toplevel(parent)
        self.top.title(title)
        self.top.transient(parent)
        self.top.resizable(False, False)
        self.label_var = tk.StringVar(value=message)
        ttk.Label(self.top, textvariable=self.label_var, padding=12).pack()
        self.bar = ttk.Progressbar(self.top, mode='indeterminate', length=260)
        self.bar.pack(padx=12, pady=(0, 12))
        self.bar.start(12)
        self.top.protocol('WM_DELETE_WINDOW', lambda: None)  # not closable
        self.top.update_idletasks()

    def set_message(self, message: str):
        self.label_var.set(message)
        self.top.update_idletasks()

    def close(self):
        self.bar.stop()
        self.top.destroy()


def labeled_entry(parent, label: str, variable, row: int, column: int = 0,
                  width: int = 12, tooltip: str = None):
    """Grid a `label: [entry]` pair; returns the entry widget."""
    lbl = ttk.Label(parent, text=label)
    lbl.grid(row=row, column=column, sticky='w', padx=(4, 2), pady=2)
    entry = ttk.Entry(parent, textvariable=variable, width=width)
    entry.grid(row=row, column=column + 1, sticky='we', padx=(0, 4), pady=2)
    if tooltip:
        ToolTip(lbl, tooltip)
        ToolTip(entry, tooltip)
    return entry


def labeled_combo(parent, label: str, variable, values, row: int, column: int = 0,
                  width: int = 10, tooltip: str = None):
    lbl = ttk.Label(parent, text=label)
    lbl.grid(row=row, column=column, sticky='w', padx=(4, 2), pady=2)
    combo = ttk.Combobox(parent, textvariable=variable, values=list(values),
                         state='readonly', width=width)
    combo.grid(row=row, column=column + 1, sticky='we', padx=(0, 4), pady=2)
    if tooltip:
        ToolTip(lbl, tooltip)
    return combo


def labeled_scale(parent, label: str, variable, from_, to, row: int,
                  column: int = 0, tooltip: str = None):
    lbl = ttk.Label(parent, text=label)
    lbl.grid(row=row, column=column, sticky='w', padx=(4, 2), pady=2)
    scale = ttk.Scale(parent, variable=variable, from_=from_, to=to,
                      orient='horizontal')
    scale.grid(row=row, column=column + 1, sticky='we', padx=(0, 4), pady=2)
    if tooltip:
        ToolTip(lbl, tooltip)
    return scale
