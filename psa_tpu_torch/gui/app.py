"""Interactive Tkinter GUI: load → SED → click → iSED → animate workflow.

Carried over from :mod:`psa_tpu.gui.app`: Tk and matplotlib code with no
array library in it.  ``main`` takes ``--device`` ('cuda' by default) and
hands it to the controller; without a card it stops at start-up with the
calculator's message and opens no window.  Importing this module needs
tkinter and matplotlib but no display; constructing the window needs one.

Capability-parity rebuild of the reference GUI (reference:
src/psa/gui/psa_gui.py:139-3057): paned layout with a control notebook
(I/O / Calculation / Plot / Reconstruction) and a plot notebook
(Reciprocal / Real space); trajectory loading with cache detection; k-path and
k-grid SED runs on daemon worker threads with results marshaled back via
``root.after``; click-to-select (k, ω) enabling iSED; frequency-slider k-grid
heatmap browsing with a cached global color scale; 3D atomic-motion animation;
npy/CSV/GIF/image exports.

All analysis state lives in :class:`psa_tpu_torch.gui.controller.AnalysisController`
(headless-testable); this module is Tk plumbing only.
"""
from __future__ import annotations

import argparse
import logging
import threading
import tkinter as tk
from pathlib import Path
from tkinter import filedialog, messagebox, ttk

import matplotlib
import matplotlib.pyplot as plt
import numpy as np
from matplotlib.backends.backend_tkagg import (FigureCanvasTkAgg,
                                               NavigationToolbar2Tk)

from ..core.calculator import resolve_device
from .controller import AnalysisController, apply_scale
from .widgets import ProgressDialog, ToolTip, labeled_combo, labeled_entry

logger = logging.getLogger(__name__)


class PSAMainWindow:
    """Main application window."""

    def __init__(self, root: tk.Tk, device='cuda'):
        self.root = root
        self.controller = AnalysisController(device=device)
        self.root.title(f"PSA (PyTorch, {self.controller.device}) — "
                        "Phonon Spectral Analysis")
        self.root.geometry("1380x860")
        self._anim_job = None
        self._anim_frame = 0
        self._ised_motion = None

        self._init_variables()
        self._build_layout()
        self.root.protocol('WM_DELETE_WINDOW', self._on_quit)

    # ------------------------------------------------------------------
    # State variables (GUI defaults mirror the reference: nk=250, bz=4.0,
    # dsqrt scaling, inferno colormap; psa_gui.py:327,335,474,483)
    # ------------------------------------------------------------------
    def _init_variables(self):
        v = self
        v.traj_path = tk.StringVar()
        v.file_format = tk.StringVar(value='auto')
        v.dt_var = tk.DoubleVar(value=0.001)
        v.nx_var = tk.IntVar(value=1)
        v.ny_var = tk.IntVar(value=1)
        v.nz_var = tk.IntVar(value=1)
        v.use_disp_var = tk.BooleanVar(value=False)
        v.status_var = tk.StringVar(value="No trajectory loaded.")

        v.direction_var = tk.StringVar(value='[1,0,0]')
        v.nk_var = tk.IntVar(value=250)
        v.bz_var = tk.DoubleVar(value=4.0)
        v.lat_param_var = tk.StringVar(value='')
        v.basis_types_var = tk.StringVar(value='')
        v.mode_var = tk.StringVar(value='coherent')
        v.welch_var = tk.StringVar(value='')
        v.pol_var = tk.StringVar(value='total')
        v.dsf_self_var = tk.BooleanVar(value=False)
        v.chiral_var = tk.BooleanVar(value=False)
        v.chiral_axis_var = tk.StringVar(value='z')
        v.angle_opt_var = tk.StringVar(value='C')
        v.npt_var = tk.BooleanVar(value=False)
        v.grid_npt_var = tk.BooleanVar(value=False)

        v.plane_var = tk.StringVar(value='xy')
        v.k1_min_var = tk.DoubleVar(value=-2.0)
        v.k1_max_var = tk.DoubleVar(value=2.0)
        v.k2_min_var = tk.DoubleVar(value=-2.0)
        v.k2_max_var = tk.DoubleVar(value=2.0)
        v.nk1_var = tk.IntVar(value=40)
        v.nk2_var = tk.IntVar(value=40)
        v.k_fixed_var = tk.DoubleVar(value=0.0)
        v.grid_max_freq_var = tk.StringVar(value='')
        v.grid_chiral_var = tk.BooleanVar(value=False)
        v.grid_engine_var = tk.StringVar(value='auto')
        v.grid_pol_var = tk.StringVar(value='total')
        v.width_method_var = tk.StringVar(value='lorentzian')

        v.aspect_var = tk.StringVar(value='')
        v.scale_var = tk.StringVar(value='dsqrt')
        v.cmap_var = tk.StringVar(value='inferno')
        v.max_freq_var = tk.StringVar(value='')
        v.show_phase_var = tk.BooleanVar(value=False)
        v.theme_var = tk.StringVar(value='light')

        v.ised_dir_var = tk.StringVar(value='x')
        v.ised_len_var = tk.DoubleVar(value=5.43)
        v.ised_nk_var = tk.IntVar(value=100)
        v.ised_bz_var = tk.DoubleVar(value=1.0)
        v.ised_rescale_var = tk.StringVar(value='auto')
        v.ised_frames_var = tk.IntVar(value=100)
        v.selected_var = tk.StringVar(value="No point selected.")
        v.fps_var = tk.IntVar(value=15)
        v.point_size_var = tk.DoubleVar(value=20.0)
        v.alpha_var = tk.DoubleVar(value=0.9)
        v.freq_slider_var = tk.DoubleVar(value=0.0)
        v.freq_label_var = tk.StringVar(value="")

    # ------------------------------------------------------------------
    # Layout
    # ------------------------------------------------------------------
    def _build_layout(self):
        paned = ttk.PanedWindow(self.root, orient='horizontal')
        paned.pack(fill='both', expand=True)

        controls = ttk.Frame(paned, width=380)
        paned.add(controls, weight=0)
        plots = ttk.Frame(paned)
        paned.add(plots, weight=1)

        self.control_nb = ttk.Notebook(controls)
        self.control_nb.pack(fill='both', expand=True, padx=4, pady=4)
        self._build_io_tab()
        self._build_calc_tab()
        self._build_plot_tab()
        self._build_recon_tab()

        self.plot_nb = ttk.Notebook(plots)
        self.plot_nb.pack(fill='both', expand=True, padx=4, pady=4)
        self._build_reciprocal_tab()
        self._build_realspace_tab()

        status = ttk.Label(self.root, textvariable=self.status_var, anchor='w',
                           relief='sunken')
        status.pack(fill='x', side='bottom')

    def _build_io_tab(self):
        tab = ttk.Frame(self.control_nb)
        self.control_nb.add(tab, text="I/O")

        lf = ttk.LabelFrame(tab, text="Trajectory")
        lf.pack(fill='x', padx=4, pady=4)
        row = ttk.Frame(lf)
        row.pack(fill='x', pady=2)
        ttk.Entry(row, textvariable=self.traj_path).pack(side='left', fill='x',
                                                         expand=True, padx=4)
        ttk.Button(row, text="Browse…", command=self._browse_trajectory).pack(side='right', padx=4)
        grid = ttk.Frame(lf)
        grid.pack(fill='x')
        labeled_combo(grid, "Format:", self.file_format,
                      ('auto', 'lammps', 'vasp_outcar', 'extxyz', 'h5md'),
                      row=0)
        labeled_entry(grid, "dt (ps):", self.dt_var, row=1,
                      tooltip="Time between stored frames in picoseconds")
        labeled_entry(grid, "nx:", self.nx_var, row=2,
                      tooltip="Supercell repetitions along x (defines a1)")
        labeled_entry(grid, "ny:", self.ny_var, row=3)
        labeled_entry(grid, "nz:", self.nz_var, row=4)
        ttk.Checkbutton(lf, text="Use displacements (instead of velocities)",
                        variable=self.use_disp_var).pack(anchor='w', padx=4)
        self.load_btn = ttk.Button(lf, text="Load Trajectory", command=self._load_trajectory)
        self.load_btn.pack(pady=4)

        ex = ttk.LabelFrame(tab, text="Export")
        ex.pack(fill='x', padx=4, pady=4)
        ttk.Button(ex, text="Save SED data (.npy set)…",
                   command=self._save_npy).pack(fill='x', padx=4, pady=2)
        ttk.Button(ex, text="Save data as CSV…",
                   command=self._save_csv).pack(fill='x', padx=4, pady=2)
        ttk.Button(ex, text="Save current plot image…",
                   command=self._save_plot_image).pack(fill='x', padx=4, pady=2)
        ttk.Button(ex, text="Save k-grid animation (GIF)…",
                   command=self._save_gif).pack(fill='x', padx=4, pady=2)
        ttk.Button(ex, text="Save iSED trajectory…",
                   command=self._save_ised).pack(fill='x', padx=4, pady=2)

    def _build_calc_tab(self):
        tab = ttk.Frame(self.control_nb)
        self.control_nb.add(tab, text="Calculation")

        lf = ttk.LabelFrame(tab, text="k-path SED")
        lf.pack(fill='x', padx=4, pady=4)
        grid = ttk.Frame(lf)
        grid.pack(fill='x')
        labeled_entry(grid, "Direction:", self.direction_var, row=0,
                      tooltip="'x', '110', 45.0, [1,0,0], or {'h':1,'k':0,'l':0}")
        labeled_entry(grid, "n_k:", self.nk_var, row=1)
        labeled_entry(grid, "BZ coverage:", self.bz_var, row=2)
        labeled_entry(grid, "Lattice param (Å):", self.lat_param_var, row=3,
                      tooltip="Blank = auto from reciprocal projection")
        labeled_entry(grid, "Basis types:", self.basis_types_var, row=4,
                      tooltip="Comma-separated atom types, e.g. 1,2 (blank = all)")
        labeled_combo(grid, "Summation:", self.mode_var,
                      ('coherent', 'incoherent'), row=5)
        labeled_entry(grid, "Welch segments:", self.welch_var, row=6,
                      tooltip="Blank = single full-length FFT; N = average N "
                              "time windows (smoother lines, 1/N resolution; "
                              "not compatible with chiral phase)")
        labeled_combo(grid, "Polarization:", self.pol_var,
                      ('total', 'longitudinal', 'transverse'), row=7,
                      tooltip="longitudinal = |k̂·Φ|² (LA branches), "
                              "transverse = total − longitudinal (TA); "
                              "not compatible with chiral/Welch")
        chiral_row = ttk.Frame(lf)
        chiral_row.pack(fill='x')
        ttk.Checkbutton(chiral_row, text="Chiral phase", variable=self.chiral_var
                        ).pack(side='left', padx=4)
        ttk.Combobox(chiral_row, textvariable=self.chiral_axis_var, width=3,
                     values=('x', 'y', 'z'), state='readonly').pack(side='left')
        ttk.Combobox(chiral_row, textvariable=self.angle_opt_var, width=3,
                     values=('A', 'B', 'C'), state='readonly').pack(side='left', padx=4)
        self.npt_chk = ttk.Checkbutton(chiral_row,
                                       text="NPT (fractional anchor)",
                                       variable=self.npt_var,
                                       state='disabled')
        self.npt_chk.pack(side='left', padx=(12, 0))
        ToolTip(self.npt_chk,
                "Time-dependent (NPT) cell: anchor phases on per-frame "
                "fractional coordinates so phonon lines stay sharp under "
                "cell breathing/drift. Direction is an integer Miller "
                "vector; BZ coverage becomes the max Miller order. Enabled "
                "when the loaded dump carries per-frame cells.")
        kbtns = ttk.Frame(lf)
        kbtns.pack(pady=4)
        self.calc_btn = ttk.Button(kbtns, text="Calculate SED",
                                   state='disabled',
                                   command=self._calculate_kpath)
        self.calc_btn.pack(side='left', padx=2)
        self.dos_btn = ttk.Button(kbtns, text="DOS", state='disabled',
                                  command=self._calculate_dos)
        self.dos_btn.pack(side='left', padx=2)
        ToolTip(self.dos_btn,
                "Vibrational density of states (velocity-autocorrelation "
                "transform), computed on device; one curve per atom type "
                "when a flat type list is set")
        self.dsf_btn = ttk.Button(kbtns, text="DSF", state='disabled',
                                  command=self._calculate_dsf)
        self.dsf_btn.pack(side='left', padx=2)
        ToolTip(self.dsf_btn,
                "Instantaneous-phase map over this k-path (snapped to "
                "box-commensurate k): Polarization 'total' → S(k,ω) "
                "(dynamic structure factor), 'longitudinal' → C_L, "
                "'transverse' → C_T current spectra — anharmonic shifts "
                "and broadening the harmonic SED cannot see")
        self.dsf_self_chk = ttk.Checkbutton(kbtns, text="self",
                                            variable=self.dsf_self_var)
        self.dsf_self_chk.pack(side='left')
        ToolTip(self.dsf_self_chk,
                "DSF computes the SELF (incoherent) part S_s(k,ω) instead "
                "— single-particle motion; its quasi-elastic width vs k² "
                "gives the self-diffusion coefficient")
        self.liquid_var = tk.StringVar(value='S(k)')
        self.liquid_combo = ttk.Combobox(
            kbtns, textvariable=self.liquid_var, width=6, state='readonly',
            values=('S(k)', 'g(r)', 'MSD', 'VACF', 'F_s'))
        self.liquid_combo.pack(side='left', padx=(8, 0))
        self.liquid_btn = ttk.Button(kbtns, text="Liquid", state='disabled',
                                     command=self._calculate_liquid)
        self.liquid_btn.pack(side='left', padx=2)
        ToolTip(self.liquid_btn,
                "Liquid-workflow curves on device: static structure factor "
                "S(k) over this k-path (snapped), radial distribution "
                "function g(r), mean-squared displacement, or velocity "
                "autocorrelation — one curve per atom type where a flat "
                "type list is set")

        gf = ttk.LabelFrame(tab, text="k-grid SED")
        gf.pack(fill='x', padx=4, pady=4)
        ggrid = ttk.Frame(gf)
        ggrid.pack(fill='x')
        labeled_combo(ggrid, "Plane:", self.plane_var, ('xy', 'yz', 'zx'), row=0)
        labeled_entry(ggrid, "k1 min:", self.k1_min_var, row=1)
        labeled_entry(ggrid, "k1 max:", self.k1_max_var, row=2)
        labeled_entry(ggrid, "k2 min:", self.k2_min_var, row=3)
        labeled_entry(ggrid, "k2 max:", self.k2_max_var, row=4)
        labeled_entry(ggrid, "n_k1:", self.nk1_var, row=5)
        labeled_entry(ggrid, "n_k2:", self.nk2_var, row=6)
        labeled_entry(ggrid, "Fixed k⊥:", self.k_fixed_var, row=7,
                      tooltip="Out-of-plane k component (own field — the "
                              "reference reused the kx-max entry for this)")
        labeled_entry(ggrid, "Max freq (THz):", self.grid_max_freq_var, row=8,
                      tooltip="Blank = keep all positive frequencies")
        labeled_combo(ggrid, "Engine:", self.grid_engine_var,
                      ('auto', 'direct', 'gridded'), row=9,
                      tooltip="auto = the direct engine; gridded = the "
                              "NUFFT engine for uniform coherent grids "
                              "(PERF.md holds the walls of both)")
        labeled_combo(ggrid, "Polarization:", self.grid_pol_var,
                      ('total', 'longitudinal', 'transverse'), row=11,
                      tooltip="longitudinal = |k̂·Φ|² per grid point (LA), "
                              "transverse = total − longitudinal (TA); "
                              "direct engine, not compatible with chiral")
        labeled_combo(ggrid, "Linewidth:", self.width_method_var,
                      ('lorentzian', 'rms'), row=10,
                      tooltip="Peak-surface linewidths: 'lorentzian' = "
                              "calibrated FWHM (closed-form fit); 'rms' = "
                              "window-spread proxy")
        ttk.Checkbutton(gf, text="Chiral phase on grid",
                        variable=self.grid_chiral_var).pack(anchor='w', padx=4)
        self.grid_npt_chk = ttk.Checkbutton(
            gf, text="NPT (fractional Miller grid)",
            variable=self.grid_npt_var, state='disabled')
        self.grid_npt_chk.pack(anchor='w', padx=4)
        ToolTip(self.grid_npt_chk,
                "Time-dependent (NPT) cell: the grid ranges become "
                "FRACTIONAL Miller coordinates and phases anchor on "
                "per-frame fractional positions. Direct engine, "
                "polarization 'total'. Enabled when the loaded dump "
                "carries per-frame cells.")
        btns = ttk.Frame(gf)
        btns.pack(pady=4)
        self.grid_btn = ttk.Button(btns, text="Calculate k-grid",
                                   state='disabled',
                                   command=self._calculate_kgrid)
        self.grid_btn.pack(side='left', padx=2)
        self.peaks_btn = ttk.Button(btns, text="Peak surface",
                                    state='disabled',
                                    command=self._calculate_kgrid_peaks)
        self.peaks_btn.pack(side='left', padx=2)
        ToolTip(self.peaks_btn,
                "Dispersion surface via on-device peak extraction — only "
                "the per-k peak frequency/intensity/linewidth cross to "
                "the host, not the full browse planes")

    def _build_plot_tab(self):
        tab = ttk.Frame(self.control_nb)
        self.control_nb.add(tab, text="Plot")
        lf = ttk.LabelFrame(tab, text="Dispersion plot options")
        lf.pack(fill='x', padx=4, pady=4)
        grid = ttk.Frame(lf)
        grid.pack(fill='x')
        labeled_combo(grid, "Scaling:", self.scale_var,
                      ('linear', 'log', 'sqrt', 'dsqrt'), row=0)
        labeled_combo(grid, "Colormap:", self.cmap_var,
                      ('inferno', 'viridis', 'magma', 'plasma', 'twilight',
                       'coolwarm', 'hot'), row=1)
        labeled_entry(grid, "Max freq (THz):", self.max_freq_var, row=2,
                      tooltip="Blank = full positive range")
        labeled_combo(grid, "Theme:", self.theme_var, ('light', 'dark'), row=3)
        labeled_entry(grid, "Save aspect:", self.aspect_var, row=4,
                      tooltip="Aspect ratio for saved plot images: '16:9', "
                              "'4:3', a number, or blank to keep the "
                              "on-screen shape")
        ttk.Checkbutton(lf, text="Show chiral phase (instead of intensity)",
                        variable=self.show_phase_var).pack(anchor='w', padx=4)
        self.plot_btn = ttk.Button(lf, text="Generate Plot", state='disabled',
                                   command=self._draw_kpath_plot)
        self.plot_btn.pack(pady=4)

    def _build_recon_tab(self):
        tab = ttk.Frame(self.control_nb)
        self.control_nb.add(tab, text="Reconstruction")
        lf = ttk.LabelFrame(tab, text="iSED mode reconstruction")
        lf.pack(fill='x', padx=4, pady=4)
        ttk.Label(lf, textvariable=self.selected_var).pack(anchor='w', padx=4)
        grid = ttk.Frame(lf)
        grid.pack(fill='x')
        labeled_entry(grid, "Direction:", self.ised_dir_var, row=0)
        labeled_entry(grid, "Char. length (Å):", self.ised_len_var, row=1)
        labeled_entry(grid, "n_k on path:", self.ised_nk_var, row=2)
        labeled_entry(grid, "BZ coverage:", self.ised_bz_var, row=3)
        labeled_entry(grid, "Rescale:", self.ised_rescale_var, row=4,
                      tooltip="'auto' or a numeric amplification factor")
        labeled_entry(grid, "Frames:", self.ised_frames_var, row=5)
        self.recon_btn = ttk.Button(lf, text="Reconstruct Mode", state='disabled',
                                    command=self._reconstruct_ised)
        self.recon_btn.pack(pady=4)

        af = ttk.LabelFrame(tab, text="Animation")
        af.pack(fill='x', padx=4, pady=4)
        agrid = ttk.Frame(af)
        agrid.pack(fill='x')
        labeled_entry(agrid, "FPS:", self.fps_var, row=0)
        labeled_entry(agrid, "Point size:", self.point_size_var, row=1)
        labeled_entry(agrid, "Alpha:", self.alpha_var, row=2)
        btns = ttk.Frame(af)
        btns.pack()
        self.play_btn = ttk.Button(btns, text="▶ Play", state='disabled',
                                   command=self._play_animation)
        self.play_btn.pack(side='left', padx=2, pady=4)
        self.pause_btn = ttk.Button(btns, text="⏸ Pause", state='disabled',
                                    command=self._pause_animation)
        self.pause_btn.pack(side='left', padx=2)
        self.reset_btn = ttk.Button(btns, text="⏮ Reset", state='disabled',
                                    command=self._reset_animation)
        self.reset_btn.pack(side='left', padx=2)
        ttk.Button(af, text="Open in OVITO (external)",
                   command=self._open_in_ovito).pack(pady=2)

    def _build_reciprocal_tab(self):
        tab = ttk.Frame(self.plot_nb)
        self.plot_nb.add(tab, text="Reciprocal Space")
        self.recip_fig = plt.Figure(figsize=(7.5, 6), dpi=100)
        self.recip_canvas = FigureCanvasTkAgg(self.recip_fig, master=tab)
        self.recip_canvas.get_tk_widget().pack(fill='both', expand=True)
        NavigationToolbar2Tk(self.recip_canvas, tab)
        self.recip_canvas.mpl_connect('button_press_event', self._on_plot_click)

        slider_row = ttk.Frame(tab)
        slider_row.pack(fill='x')
        ttk.Label(slider_row, text="k-grid frequency:").pack(side='left', padx=4)
        self.freq_slider = ttk.Scale(slider_row, variable=self.freq_slider_var,
                                     from_=0, to=0, orient='horizontal',
                                     command=self._on_freq_slider)
        self.freq_slider.pack(side='left', fill='x', expand=True, padx=4)
        ttk.Label(slider_row, textvariable=self.freq_label_var, width=14
                  ).pack(side='right', padx=4)

    def _build_realspace_tab(self):
        tab = ttk.Frame(self.plot_nb)
        self.plot_nb.add(tab, text="Real Space")
        self.real_fig = plt.Figure(figsize=(7.5, 6), dpi=100)
        self.real_canvas = FigureCanvasTkAgg(self.real_fig, master=tab)
        self.real_canvas.get_tk_widget().pack(fill='both', expand=True)

    # ------------------------------------------------------------------
    # I/O actions
    # ------------------------------------------------------------------
    def _browse_trajectory(self):
        path = filedialog.askopenfilename(
            title="Select trajectory",
            filetypes=[("LAMMPS dump", "*.dump *.lammpstrj *.txt"),
                       ("VASP OUTCAR", "*.OUTCAR *.outcar"), ("All", "*.*")])
        if path:
            self.traj_path.set(path)
            if self.controller.has_cache(path):
                self.status_var.set("Trajectory selected (npy cache found — fast load).")
            else:
                self.status_var.set("Trajectory selected.")
            self.load_btn.state(['!disabled'])

    def _load_trajectory(self):
        path = self.traj_path.get()
        if not path:
            messagebox.showerror("PSA", "Choose a trajectory file first.")
            return
        dialog = ProgressDialog(self.root, "Loading", f"Loading {Path(path).name}…")

        def work():
            try:
                traj = self.controller.load_trajectory(
                    path, dt=self.dt_var.get(), file_format=self.file_format.get(),
                    nx=self.nx_var.get(), ny=self.ny_var.get(), nz=self.nz_var.get(),
                    use_displacements=self.use_disp_var.get())
                msg = (f"Loaded {Path(path).name}: {traj.n_frames} frames, "
                       f"{traj.n_atoms} atoms.")
                err = None
            except Exception as e:
                msg, err = None, str(e)

            def done():
                dialog.close()
                if err:
                    self.status_var.set("Load failed.")
                    messagebox.showerror("PSA", f"Load failed: {err}")
                else:
                    self.status_var.set(msg)
                    for b in (self.calc_btn, self.grid_btn, self.peaks_btn,
                              self.dos_btn, self.dsf_btn, self.liquid_btn):
                        b.state(['!disabled'])
                    traj2 = self.controller.trajectory
                    has_npt = (traj2 is not None
                               and traj2.box_matrices is not None)
                    for chk, var in ((self.npt_chk, self.npt_var),
                                     (self.grid_npt_chk,
                                      self.grid_npt_var)):
                        chk.state(['!disabled' if has_npt else 'disabled'])
                        if not has_npt:
                            var.set(False)
            self.root.after(0, done)

        threading.Thread(target=work, daemon=True).start()

    # ------------------------------------------------------------------
    # k-path SED
    # ------------------------------------------------------------------
    def _basis_types(self):
        text = self.basis_types_var.get().strip()
        if not text:
            return None
        return [int(t) for t in text.replace(',', ' ').split()]

    def _calculate_kpath(self):
        dialog = ProgressDialog(self.root, "Calculating", "Computing k-path SED…")

        def work():
            try:
                lat = self.lat_param_var.get().strip()
                welch = (int(self.welch_var.get())
                         if self.welch_var.get().strip() else None)
                if self.npt_var.get():
                    if self.pol_var.get() != 'total':
                        raise ValueError("The L/T split is fixed-cell only; "
                                         "set Polarization to 'total' for "
                                         "NPT.")
                    self.controller.compute_npt_sed(
                        self.direction_var.get(), n_k=self.nk_var.get(),
                        max_order=self.bz_var.get(),
                        basis_atom_types=self._basis_types(),
                        summation_mode=self.mode_var.get(),
                        chiral=self.chiral_var.get(),
                        chiral_axis=self.chiral_axis_var.get(),
                        angle_range_opt=self.angle_opt_var.get(),
                        welch_segments=welch)
                else:
                    self.controller.compute_kpath_sed(
                        self.direction_var.get(), n_k=self.nk_var.get(),
                        bz_coverage=self.bz_var.get(),
                        lattice_param=float(lat) if lat else None,
                        basis_atom_types=self._basis_types(),
                        summation_mode=self.mode_var.get(),
                        chiral=self.chiral_var.get(),
                        chiral_axis=self.chiral_axis_var.get(),
                        angle_range_opt=self.angle_opt_var.get(),
                        welch_segments=welch,
                        polarization=self.pol_var.get())
                err = None
            except Exception as e:
                err = str(e)

            def done():
                dialog.close()
                if err:
                    messagebox.showerror("PSA", f"SED calculation failed: {err}")
                    return
                self.status_var.set("k-path SED computed.")
                self.plot_btn.state(['!disabled'])
                self._draw_kpath_plot()
            self.root.after(0, done)

        threading.Thread(target=work, daemon=True).start()

    def _draw_kpath_plot(self):
        try:
            max_freq = float(self.max_freq_var.get()) if self.max_freq_var.get().strip() else None
            k, f, c = self.controller.kpath_plot_arrays(
                scale=self.scale_var.get(), max_freq=max_freq,
                show_phase=self.show_phase_var.get())
        except Exception as e:
            messagebox.showerror("PSA", str(e))
            return
        self.recip_fig.clear()
        ax = self.recip_fig.add_subplot(111)
        dark = self.theme_var.get() == 'dark'
        self.recip_fig.patch.set_facecolor('black' if dark else 'white')
        ax.set_facecolor('black' if dark else 'white')
        fg = 'white' if dark else 'black'
        if self.show_phase_var.get():
            pcm = ax.pcolormesh(k, f, c, cmap=self.cmap_var.get(),
                                shading='gouraud', vmin=-np.pi / 2, vmax=np.pi / 2)
        else:
            pcm = ax.pcolormesh(k, f, c, cmap=self.cmap_var.get(), shading='gouraud')
        cbar = self.recip_fig.colorbar(pcm, ax=ax)
        cbar.ax.tick_params(colors=fg)
        ax.set_xlabel('k (2π/Å)', color=fg)
        ax.set_ylabel('Frequency (THz)', color=fg)
        ax.tick_params(colors=fg)
        pol = self.pol_var.get()
        tag = '' if pol == 'total' else f' ({pol})'
        ax.set_title(f'SED dispersion{tag} — click to select a mode for iSED',
                     color=fg)
        if self.controller.selected_point:
            kc, wc = self.controller.selected_point
            ax.plot(kc, wc, 'g+', markersize=12, markeredgewidth=2)
        self.recip_fig.tight_layout()
        self.recip_canvas.draw_idle()
        self.plot_nb.select(0)

    def _on_plot_click(self, event):
        if event.inaxes is None or self.controller.sed_result is None:
            return
        if event.xdata is None or event.ydata is None:
            return
        try:
            k, w = self.controller.select_nearest(float(event.xdata), float(event.ydata))
        except Exception:
            return
        self.selected_var.set(f"Selected: k = {k:.4f} 2π/Å, ω = {w:.3f} THz")
        self.recon_btn.state(['!disabled'])
        self._draw_kpath_plot()

    # ------------------------------------------------------------------
    # k-grid SED + heatmap browsing
    # ------------------------------------------------------------------
    def _calculate_kgrid(self):
        dialog = ProgressDialog(self.root, "Calculating",
                                "Computing k-grid SED (this can take a while)…")

        def work():
            try:
                mf = self.grid_max_freq_var.get().strip()
                self.controller.compute_kgrid_sed(
                    self.plane_var.get(),
                    (self.k1_min_var.get(), self.k1_max_var.get()),
                    (self.k2_min_var.get(), self.k2_max_var.get()),
                    self.nk1_var.get(), self.nk2_var.get(),
                    k_fixed=self.k_fixed_var.get(),
                    max_freq=float(mf) if mf else None,
                    basis_atom_types=self._basis_types(),
                    summation_mode=self.mode_var.get(),
                    chiral=self.grid_chiral_var.get(),
                    chiral_axis=self.chiral_axis_var.get(),
                    engine=self.grid_engine_var.get(),
                    polarization=self.grid_pol_var.get(),
                    npt=self.grid_npt_var.get())
                err = None
            except Exception as e:
                err = str(e)

            def done():
                dialog.close()
                if err:
                    messagebox.showerror("PSA", f"k-grid calculation failed: {err}")
                    return
                kg = self.controller.kgrid
                self.freq_slider.configure(to=len(kg.freqs) - 1)
                self.freq_slider_var.set(0)
                self.status_var.set(
                    f"k-grid SED computed: {kg.sed.k_grid_shape[0]}×{kg.sed.k_grid_shape[1]} "
                    f"k-points, {len(kg.freqs)} frequencies.")
                self._draw_kgrid_heatmap(0)
            self.root.after(0, done)

        threading.Thread(target=work, daemon=True).start()

    def _calculate_dos(self):
        dialog = ProgressDialog(self.root, "Calculating",
                                "Computing vibrational DOS on device…")

        def work():
            try:
                mf = self.max_freq_var.get().strip()
                types = self._basis_types()
                freqs, dos = self.controller.compute_dos(
                    basis_atom_types=types,
                    max_freq=float(mf) if mf else None)
                err = None
            except Exception as e:
                freqs, dos, err = None, None, str(e)

            def done():
                dialog.close()
                if err:
                    messagebox.showerror("PSA", f"DOS failed: {err}")
                    return
                self.recip_fig.clear()
                ax = self.recip_fig.add_subplot(111)
                # calculate_dos drops types with no atoms, so the raw type
                # list can be longer than the rows — only attribute labels
                # when the correspondence is unambiguous
                if types and dos.shape[0] == len(types) and dos.shape[0] > 1:
                    labels = [f"type {t}" for t in types]
                elif dos.shape[0] > 1:
                    labels = [f"group {i + 1}" for i in range(dos.shape[0])]
                else:
                    labels = ["total"]
                for row, lab in zip(dos, labels):
                    ax.plot(freqs, row, label=lab)
                ax.set_xlabel("frequency (THz)")
                ax.set_ylabel("DOS (arb.)")
                ax.set_title("Vibrational density of states")
                if len(labels) > 1:
                    ax.legend()
                self.recip_fig.tight_layout()
                self.recip_canvas.draw_idle()
                self.plot_nb.select(0)
                self.status_var.set(
                    f"DOS computed ({dos.shape[0]} curve(s)).")
            self.root.after(0, done)

        threading.Thread(target=work, daemon=True).start()

    def _calculate_liquid(self):
        kind = {'S(k)': 'sk', 'g(r)': 'rdf', 'MSD': 'msd',
                'VACF': 'vacf', 'F_s': 'isf_self'}[self.liquid_var.get()]
        dialog = ProgressDialog(self.root, "Calculating",
                                f"Computing {self.liquid_var.get()} on device…")

        def work():
            try:
                lat = self.lat_param_var.get().strip()
                types = self._basis_types()
                x, curves, xlabel, ylabel = \
                    self.controller.compute_liquid_curve(
                        kind, direction_text=self.direction_var.get(),
                        n_k=self.nk_var.get(),
                        bz_coverage=self.bz_var.get(),
                        lattice_param=float(lat) if lat else None,
                        basis_atom_types=types)
                err = None
            except Exception as e:
                x = curves = xlabel = ylabel = None
                err = str(e)

            def done():
                dialog.close()
                if err:
                    messagebox.showerror(
                        "PSA", f"{self.liquid_var.get()} failed: {err}")
                    return
                self.recip_fig.clear()
                ax = self.recip_fig.add_subplot(111)
                labels = self.controller.liquid.curve_labels
                for row, lab in zip(curves, labels):
                    ax.plot(x, row, label=lab)
                if kind in ('sk', 'rdf'):
                    ax.axhline(1.0, color='k', ls=':', lw=0.8)
                ax.set_xlabel(xlabel)
                ax.set_ylabel(ylabel)
                ax.set_title(self.liquid_var.get())
                if len(labels) > 1:
                    ax.legend()
                self.recip_fig.tight_layout()
                self.recip_canvas.draw_idle()
                self.plot_nb.select(0)
                self.status_var.set(
                    f"{self.liquid_var.get()} computed "
                    f"({curves.shape[0]} curve(s), {curves.shape[1]} points).")
            self.root.after(0, done)

        threading.Thread(target=work, daemon=True).start()

    def _calculate_dsf(self):
        observable = 'self' if self.dsf_self_var.get() else self.pol_var.get()
        dialog = ProgressDialog(
            self.root, "Calculating",
            "Computing instantaneous-phase map on device…")

        def work():
            try:
                lat = self.lat_param_var.get().strip()
                mf = self.max_freq_var.get().strip()
                k_mags, freqs, plane = self.controller.compute_kpath_dsf(
                    self.direction_var.get(), n_k=self.nk_var.get(),
                    bz_coverage=self.bz_var.get(),
                    lattice_param=float(lat) if lat else None,
                    basis_atom_types=self._basis_types(),
                    max_freq=float(mf) if mf else None,
                    observable=observable)
                err = None
            except Exception as e:
                k_mags, freqs, plane, err = None, None, None, str(e)

            def done():
                dialog.close()
                if err:
                    messagebox.showerror("PSA", f"DSF failed: {err}")
                    return
                title = {'total': 'S(k,ω) — dynamic structure factor',
                         'longitudinal': 'C_L(k,ω) — longitudinal current',
                         'transverse': 'C_T(k,ω) — transverse current',
                         'self': 'S_s(k,ω) — self (incoherent) part'}[observable]
                self.recip_fig.clear()
                ax = self.recip_fig.add_subplot(111)
                dark = self.theme_var.get() == 'dark'
                self.recip_fig.patch.set_facecolor('black' if dark else 'white')
                ax.set_facecolor('black' if dark else 'white')
                fg = 'white' if dark else 'black'
                shown = apply_scale(plane, self.scale_var.get())
                pcm = ax.pcolormesh(k_mags, freqs, shown,
                                    cmap=self.cmap_var.get(), shading='gouraud')
                cbar = self.recip_fig.colorbar(pcm, ax=ax)
                cbar.ax.tick_params(colors=fg)
                ax.set_xlabel('k (2π/Å)', color=fg)
                ax.set_ylabel('Frequency (THz)', color=fg)
                ax.tick_params(colors=fg)
                ax.set_title(title + ' — instantaneous phases', color=fg)
                self.recip_fig.tight_layout()
                self.recip_canvas.draw_idle()
                self.plot_nb.select(0)
                self.status_var.set(
                    f"DSF computed: {len(k_mags)} commensurate k-points "
                    f"× {len(freqs)} frequencies.")
            self.root.after(0, done)

        threading.Thread(target=work, daemon=True).start()

    def _calculate_kgrid_peaks(self):
        dialog = ProgressDialog(self.root, "Calculating",
                                "Extracting dispersion surface on device…")

        def work():
            try:
                mf = self.grid_max_freq_var.get().strip()
                pk = self.controller.compute_kgrid_peaks(
                    self.plane_var.get(),
                    (self.k1_min_var.get(), self.k1_max_var.get()),
                    (self.k2_min_var.get(), self.k2_max_var.get()),
                    self.nk1_var.get(), self.nk2_var.get(),
                    k_fixed=self.k_fixed_var.get(),
                    max_freq=float(mf) if mf else None,
                    basis_atom_types=self._basis_types(),
                    summation_mode=self.mode_var.get(),
                    engine=self.grid_engine_var.get(),
                    chiral=self.grid_chiral_var.get(),
                    chiral_axis=self.chiral_axis_var.get(),
                    width_method=self.width_method_var.get(),
                    npt=self.grid_npt_var.get())
                err = None
            except Exception as e:
                pk, err = None, str(e)

            def done():
                dialog.close()
                if err:
                    messagebox.showerror("PSA",
                                         f"Peak extraction failed: {err}")
                    return
                self._draw_peak_surface(pk)
                n1, n2 = pk.freq_surfaces.shape[1:]
                self.status_var.set(
                    f"Dispersion surface extracted: {n1}×{n2} k-points.")
            self.root.after(0, done)

        threading.Thread(target=work, daemon=True).start()

    def _draw_peak_surface(self, pk):
        self.recip_fig.clear()
        ax = self.recip_fig.add_subplot(111)
        if pk.phase_surfaces is not None:        # chiral: phase at the peaks
            pcm = ax.pcolormesh(pk.k1_axis, pk.k2_axis,
                                pk.surface(0, 'phase'), cmap='twilight',
                                vmin=-np.pi / 2, vmax=np.pi / 2,
                                shading='gouraud')
            self.recip_fig.colorbar(pcm, ax=ax,
                                    label="chiral phase at peak (rad)")
            ax.set_title("Chiral dispersion surface (top peak)")
        else:
            pcm = ax.pcolormesh(pk.k1_axis, pk.k2_axis,
                                pk.surface(0, 'freq'),
                                cmap=self.cmap_var.get(), shading='gouraud')
            self.recip_fig.colorbar(pcm, ax=ax, label="peak frequency (THz)")
            ax.set_title("Dispersion surface (top peak)")
        ax.set_xlabel(f"{pk.labels[0]} (2π/Å)")
        ax.set_ylabel(f"{pk.labels[1]} (2π/Å)")
        ax.set_aspect('equal', adjustable='box')
        self.recip_fig.tight_layout()
        self.recip_canvas.draw_idle()
        self.plot_nb.select(0)

    def _on_freq_slider(self, _value):
        if self.controller.kgrid is not None:
            self._draw_kgrid_heatmap(int(float(self.freq_slider_var.get())))

    def _draw_kgrid_heatmap(self, freq_idx: int):
        kg = self.controller.kgrid
        if kg is None:
            return
        freq_idx = int(np.clip(freq_idx, 0, len(kg.freqs) - 1))
        use_phase = self.grid_chiral_var.get() and kg.phase is not None
        data = kg.slice_at(freq_idx, use_phase=use_phase)
        scale = self.scale_var.get()
        if not use_phase:
            data = apply_scale(data, scale)
            vmin, vmax = kg.global_vrange(scale=scale)
        else:
            vmin, vmax = -np.pi / 2, np.pi / 2
        self.freq_label_var.set(f"{kg.freqs[freq_idx]:.3f} THz")

        self.recip_fig.clear()
        ax = self.recip_fig.add_subplot(111)
        pcm = ax.pcolormesh(kg.k1_axis, kg.k2_axis, data, cmap=self.cmap_var.get(),
                            shading='gouraud', vmin=vmin, vmax=vmax)
        self.recip_fig.colorbar(pcm, ax=ax)
        ax.set_xlabel(f"{kg.labels[0]} (2π/Å)")
        ax.set_ylabel(f"{kg.labels[1]} (2π/Å)")
        gpol = self.grid_pol_var.get()
        kind = ('phase' if use_phase else
                'intensity' if gpol == 'total' else f'{gpol} intensity')
        ax.set_title(f"k-grid SED @ {kg.freqs[freq_idx]:.3f} THz ({kind})")
        ax.set_aspect('equal', adjustable='box')
        self.recip_fig.tight_layout()
        self.recip_canvas.draw_idle()
        self.plot_nb.select(0)

    # ------------------------------------------------------------------
    # iSED + animation
    # ------------------------------------------------------------------
    def _reconstruct_ised(self):
        dialog = ProgressDialog(self.root, "Reconstructing", "Running iSED…")

        def work():
            try:
                rescale = self.ised_rescale_var.get().strip()
                try:
                    rescale = float(rescale)
                except ValueError:
                    pass
                self.controller.reconstruct_ised(
                    self.ised_dir_var.get(), char_len=self.ised_len_var.get(),
                    n_k=self.ised_nk_var.get(), bz_coverage=self.ised_bz_var.get(),
                    rescale=rescale, n_frames=self.ised_frames_var.get(),
                    basis_atom_types=self._basis_types())
                motion = self.controller.load_ised_motion()
                err = None
            except Exception as e:
                motion, err = None, str(e)

            def done():
                dialog.close()
                if err:
                    messagebox.showerror("PSA", f"iSED failed: {err}")
                    return
                self._ised_motion = motion
                self._anim_frame = 0
                for b in (self.play_btn, self.pause_btn, self.reset_btn):
                    b.state(['!disabled'])
                self.status_var.set("iSED reconstruction ready — see Real Space tab.")
                self._draw_motion_frame(0)
                self.plot_nb.select(1)
            self.root.after(0, done)

        threading.Thread(target=work, daemon=True).start()

    def _draw_motion_frame(self, idx: int):
        if self._ised_motion is None:
            return
        pos, types, box = self._ised_motion
        idx = idx % pos.shape[0]
        self.real_fig.clear()
        ax = self.real_fig.add_subplot(111, projection='3d')
        size = self.point_size_var.get()
        alpha = float(np.clip(self.alpha_var.get(), 0.05, 1.0))
        for t in np.unique(types):
            sel = types == t
            ax.scatter(pos[idx, sel, 0], pos[idx, sel, 1], pos[idx, sel, 2],
                       s=size, alpha=alpha, label=f"type {t}")
        ax.set_title(f"iSED motion — frame {idx + 1}/{pos.shape[0]}")
        ax.legend(loc='upper right')
        self.real_canvas.draw_idle()

    def _play_animation(self):
        self._pause_animation()

        def tick():
            self._anim_frame += 1
            self._draw_motion_frame(self._anim_frame)
            delay = max(20, int(1000 / max(1, self.fps_var.get())))
            self._anim_job = self.root.after(delay, tick)
        tick()

    def _pause_animation(self):
        if self._anim_job is not None:
            self.root.after_cancel(self._anim_job)
            self._anim_job = None

    def _reset_animation(self):
        self._pause_animation()
        self._anim_frame = 0
        self._draw_motion_frame(0)

    def _open_in_ovito(self):
        import shutil as _shutil
        import subprocess
        if self.controller.ised_dump_path is None:
            messagebox.showinfo("PSA", "Run an iSED reconstruction first.")
            return
        exe = _shutil.which('ovito')
        if exe is None:
            messagebox.showinfo("PSA", "OVITO executable not found on PATH.")
            return
        subprocess.Popen([exe, str(self.controller.ised_dump_path)])

    # ------------------------------------------------------------------
    # Exports
    # ------------------------------------------------------------------
    def _save_npy(self):
        from . import export
        if self.controller.sed_result is None:
            messagebox.showinfo("PSA", "Compute a SED first.")
            return
        path = filedialog.asksaveasfilename(title="Base path for .npy set")
        if not path:
            return
        # The .npy set historically carries the COMPLEX spectrum; with the
        # device-reduced display default that means a full-complex device
        # recompute + multi-100-MB fetch — run it on a worker thread like
        # every other device computation, never on the Tk main loop.
        dialog = ProgressDialog(self.root, "Exporting",
                                "Computing full complex spectrum…")

        def work():
            try:
                files = export.export_npy_set(
                    self.controller.full_kpath_sed(), Path(path))
                msg, err = f"Saved {len(files)} .npy files.", None
            except Exception as e:
                msg, err = None, str(e)

            def done():
                dialog.close()
                if err:
                    self.status_var.set("Export failed.")
                    messagebox.showerror("PSA", f"Export failed: {err}")
                else:
                    self.status_var.set(msg)
            self.root.after(0, done)

        threading.Thread(target=work, daemon=True).start()

    def _save_csv(self):
        from . import export
        path = filedialog.asksaveasfilename(defaultextension='.csv',
                                            filetypes=[("CSV", "*.csv")])
        if not path:
            return
        # Export the MOST RECENTLY computed grid result: after
        # "Calculate k-grid" then "Peak surface", the user expects the
        # peak-surface CSV, not the stale browse grid (and vice versa).
        prefer_peaks = (self.controller.last_grid_kind == 'peaks'
                        and self.controller.kgrid_peaks is not None)
        if (self.controller.last_compute == 'liquid'
                and self.controller.liquid is not None):
            export.export_liquid_csv(self.controller.liquid, Path(path))
        elif (self.controller.last_compute == 'dsf'
                and self.controller.dsf is not None):
            export.export_dsf_csv(self.controller.dsf, Path(path))
        elif prefer_peaks:
            export.export_peaks_csv(self.controller.kgrid_peaks, Path(path))
        elif self.controller.kgrid is not None:
            export.export_kgrid_csv(self.controller.kgrid, Path(path))
        elif self.controller.kgrid_peaks is not None:
            export.export_peaks_csv(self.controller.kgrid_peaks, Path(path))
        elif self.controller.sed_result is not None:
            export.export_kpath_csv(self.controller.sed_result, Path(path),
                                    scale=self.scale_var.get())
        else:
            messagebox.showinfo("PSA", "Nothing to export yet.")
            return
        self.status_var.set(f"CSV written: {path}")

    def _save_plot_image(self):
        from . import export
        path = filedialog.asksaveasfilename(
            defaultextension='.png',
            filetypes=[("PNG", "*.png"), ("JPEG", "*.jpg"), ("SVG", "*.svg"),
                       ("PDF", "*.pdf")])
        if path:
            current = self.plot_nb.index(self.plot_nb.select())
            fig = self.recip_fig if current == 0 else self.real_fig
            try:
                export.export_figure(fig, Path(path),
                                     aspect_ratio=self.aspect_var.get())
            except ValueError as e:
                messagebox.showerror("PSA", str(e))
                return
            self.status_var.set(f"Image saved: {path}")
            self.recip_canvas.draw_idle()
            self.real_canvas.draw_idle()

    def _save_gif(self):
        from . import export
        if self.controller.kgrid is None:
            messagebox.showinfo("PSA", "Compute a k-grid SED first.")
            return
        path = filedialog.asksaveasfilename(defaultextension='.gif',
                                            filetypes=[("GIF", "*.gif")])
        if path:
            export.export_kgrid_gif(self.controller.kgrid, Path(path),
                                    scale=self.scale_var.get(),
                                    cmap=self.cmap_var.get(),
                                    fps=self.fps_var.get(),
                                    use_phase=self.grid_chiral_var.get())
            self.status_var.set(f"GIF saved: {path}")

    def _save_ised(self):
        from . import export
        if self.controller.ised_dump_path is None:
            messagebox.showinfo("PSA", "Run an iSED reconstruction first.")
            return
        path = filedialog.asksaveasfilename(defaultextension='.dump',
                                            filetypes=[("LAMMPS dump", "*.dump")])
        if path:
            meta = {'selected_point': self.controller.selected_point,
                    'direction': self.ised_dir_var.get(),
                    'frames': self.ised_frames_var.get(),
                    'rescale': self.ised_rescale_var.get()}
            export.export_ised_dump(self.controller.ised_dump_path, Path(path), meta)
            self.status_var.set(f"iSED dump exported: {path}")

    def _on_quit(self):
        self._pause_animation()
        self.controller.cleanup()
        self.root.destroy()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Phonon Spectral Analysis GUI (PyTorch/CUDA).')
    parser.add_argument('--device', type=str, default='cuda',
                        help="Device the spectra are computed on: 'cuda' (default; "
                             "fails when no CUDA device is present) or 'cpu'.")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s - %(levelname)s - %(message)s',
                        datefmt='%H:%M:%S')
    device = resolve_device(args.device)     # before any window: raises without a card
    # Backend selection happens here, not at module import, so the module
    # stays importable in headless/test contexts running under Agg.
    matplotlib.use('TkAgg')
    root = tk.Tk()
    PSAMainWindow(root, device)
    root.mainloop()


if __name__ == "__main__":
    main()
