"""Routing histograms: epoch x layer heatmaps of stopping mass.

Counterpart of reference scripts/make-routing-hists: for each net of a
chain-experiment sweep, a heatmap whose rows are chain depths and columns
training epochs, intensity = probability mass stopping at that depth
(p_cor + p_inc of the early-exit leaf), walked positionally through
sinks[0]/sinks[1] (reference make-routing-hists:14-28)."""

from os import makedirs
from os.path import join

import numpy as np
import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from .loading import load_snapshots, chain_stop_mass  # noqa: E402


def stop_mass_history(nets_dir, expt, net_i=0, max_depth=8):
    """(n_epochs, max_depth) stopping-mass matrix, epochs in training order,
    depth index 0 = first exit (reference get_p_ev, make-routing-hists:14-28;
    the reference reverses its epoch axis only because it plots epochs on y
    with imshow's default origin='upper' -- our transposed epoch-on-x,
    origin='lower' layout wants natural order)."""
    snaps = load_snapshots(nets_dir, expt, net_i)
    h = np.zeros((len(snaps), max_depth))
    for i, desc in enumerate(snaps):
        masses = chain_stop_mass(desc, max_depth=max_depth)
        h[i, :len(masses)] = masses
    return h


def plot_routing_hists(nets_dir, expt, net_indices=(0, 1, 2, 3),
                       fig_dir="figures", max_depth=8):
    """Heatmap per net index (reference make-routing-hists:37-77)."""
    mats = []
    for i in net_indices:
        try:
            m = stop_mass_history(nets_dir, expt, i, max_depth)
        except (IndexError, KeyError, FileNotFoundError):
            m = np.zeros((0, max_depth))
        mats.append(m)
    if all(m.size == 0 for m in mats):
        return None
    fig, axes = plt.subplots(1, len(mats),
                             figsize=(1.8 * len(mats), 3.0), squeeze=False)
    for ax, m, i in zip(axes[0], mats, net_indices):
        if m.size:
            ax.imshow(m.T, vmin=0, vmax=1, cmap="hot", aspect="auto",
                      origin="lower")
        ax.set_title("net %i" % i, fontsize=9)
        ax.set_xlabel("epoch", fontsize=8)
        if i == net_indices[0]:
            ax.set_ylabel("chain depth", fontsize=8)
        ax.tick_params(labelsize=7)
    fig.suptitle(expt)
    fig.tight_layout()
    makedirs(fig_dir, exist_ok=True)
    path = join(fig_dir, "routing-hists-%s.svg" % expt)
    fig.savefig(path)
    plt.close(fig)
    return path
