#!/usr/bin/env python
"""Convenience launcher for the PyTorch/CUDA port's GUI, beside
psa_gui_launcher.py. Equivalent to the `psa-gui-torch` console script:

    python psa_gui_torch_launcher.py [--device cuda|cpu]

Needs a display, tkinter and matplotlib; computes on the CUDA device unless
`--device cpu` is given, and stops at start-up when there is no card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from psa_tpu_torch.gui.app import main

if __name__ == "__main__":
    main()
