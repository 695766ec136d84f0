"""What every example shares: the ``--device``/``--out-dir`` flags, the
output directory, the figure rule and the physics checks."""
import argparse
import warnings
from pathlib import Path

from psa_tpu_torch.core.calculator import resolve_device
from psa_tpu_torch.visualization import have_matplotlib


def parse_args(description):
    """{'device', 'out_dir'} from the command line."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default; fails without a card) or 'cpu'")
    parser.add_argument('--out-dir', default='sed_output',
                        help="directory of the data files and figures (default sed_output)")
    return vars(parser.parse_args())


def start(device, out_dir, sub=''):
    """(torch device, output directory): the device is resolved first, so a
    run asking for a missing card fails before it computes anything."""
    dev = resolve_device(device)
    out = Path(out_dir) / sub
    out.mkdir(parents=True, exist_ok=True)
    return dev, out


def figures():
    """True where matplotlib is installed (with the Agg backend); elsewhere
    one warning, and the example still writes every data file."""
    if not have_matplotlib():
        warnings.warn("matplotlib is not installed: figures are skipped; every data file "
                      "is still written.", stacklevel=2)
        return False
    import matplotlib
    matplotlib.use('Agg')
    return True


def check(ok, what):
    """Raise when a physics check misses its bound."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")
