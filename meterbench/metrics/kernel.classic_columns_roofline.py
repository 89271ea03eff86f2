"""``kernel.classic_columns_roofline``: the classic spectrogram's per-column
kernel against its least time, in %: ``roofline.least_ms`` of
``roofline_classic.classic_columns_cost`` at the cell's shape over the
mean device time of one ``classic_columns_kernel`` launch in the profiled
stretch.  Nothing where no such launch ran (a program without the kernel,
or a configuration without the classic spectrogram)."""

from meterbench import roofline
from meterbench.roofline_classic import classic_columns_cost

KERNEL = "classic_columns_kernel"
BLOCK = 256  # engine frames a hop at 48 kHz


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    ms = [(e - s) * 1e-3 for s, e, n in tr.device if KERNEL in n]
    sg = ctx.cell.config["engine"].get("spectrogram") or {}
    if not ms or sg.get("use_reassignment", True):
        return None
    least = roofline.least_ms(*classic_columns_cost(ctx.n_streams, int(sg.get("fft_size", 2048)),
                                                    int(sg.get("hop_size", 64)), BLOCK))
    return least / (sum(ms) / len(ms)) * 100.0
