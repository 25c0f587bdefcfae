"""Accuracy-vs-efficiency plots (the paper's headline figures).

Counterpart of reference scripts/make-acc-eff-plots: per experiment, the
8-point (mean op count, test error) curve; comparison panels for training
strategies, dataset complexity, and width scaling. Robust to partial runs:
only experiments present in `nets/` are plotted."""

from os import makedirs
from os.path import join

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from .loading import acc_eff_points  # noqa: E402

# Reference panel groupings (make-acc-eff-plots:50-236).
STRATEGY_PANELS = [
    ("hybrid-ac", "actor"),
    ("hybrid-ac-tree", "actor, tree"),
    ("hybrid-ac-nokdec", "actor, no k_dec"),
    ("hybrid-ac-notalr", "actor, no TALR"),
    ("hybrid-cr", "critic"),
    ("hybrid-cr-opt", "critic, optimistic"),
    ("hybrid-cr-clserr", "critic, cls err"),
    ("hybrid-cr-notalr", "critic, no TALR"),
]
COMPLEXITY_SETS = ["cifar2", "cifar5", "cifar10"]


def _curve(ax, mocs, errs, **kw):
    order = sorted(range(len(mocs)), key=lambda i: mocs[i])
    ax.plot([mocs[i] for i in order], [errs[i] for i in order],
            marker="o", ms=3, **kw)


def plot_strategy_comparison(logs, fig_dir="figures", fmt="pdf"):
    """SR baseline on the left; each dynamic-routing strategy vs SR in a
    grid of panels (reference make-acc-eff-plots:50-175)."""
    mocs, errs = acc_eff_points(logs)
    panels = [(n, t) for n, t in STRATEGY_PANELS if logs.get(n)]
    if not logs.get("hybrid-sr") and not panels:
        return None
    n = len(panels)
    ncols = min(4, max(1, n))
    nrows = -(-n // ncols) if n else 1
    fig = plt.figure(figsize=(2.6 * (ncols + 1), 2.6 * nrows))
    gs = fig.add_gridspec(nrows, ncols + 1)

    ax0 = fig.add_subplot(gs[:, 0])
    if logs.get("hybrid-sr"):
        _curve(ax0, mocs["hybrid-sr"], errs["hybrid-sr"], c="b",
               label="statically routed")
    ax0.set_xlabel("mean op count")
    ax0.set_ylabel("test error")
    ax0.set_title("SR baseline")

    for k, (name, title) in enumerate(panels):
        ax = fig.add_subplot(gs[k // ncols, 1 + k % ncols])
        if logs.get("hybrid-sr"):
            _curve(ax, mocs["hybrid-sr"], errs["hybrid-sr"], c="b",
                   alpha=0.4)
        _curve(ax, mocs[name], errs[name], c="r")
        ax.set_title(title, fontsize=9)
        ax.tick_params(labelsize=7)
    fig.tight_layout()
    makedirs(fig_dir, exist_ok=True)
    path = join(fig_dir, "acc-eff-strategies." + fmt)
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_complexity_comparison(logs, fig_dir="figures", fmt="pdf"):
    """SR vs AC across CIFAR-2/5/10 (reference make-acc-eff-plots:181-199)."""
    mocs, errs = acc_eff_points(logs)
    present = [d for d in COMPLEXITY_SETS
               if logs.get(f"{d}-sr") or logs.get(f"{d}-ac")]
    if not present:
        return None
    fig, axes = plt.subplots(1, len(present),
                             figsize=(3.0 * len(present), 2.8),
                             squeeze=False)
    for ax, d in zip(axes[0], present):
        if logs.get(f"{d}-sr"):
            _curve(ax, mocs[f"{d}-sr"], errs[f"{d}-sr"], c="b", label="SR")
        if logs.get(f"{d}-ac"):
            _curve(ax, mocs[f"{d}-ac"], errs[f"{d}-ac"], c="r", label="AC")
        ax.set_title(d)
        ax.set_xlabel("mean op count")
    axes[0][0].set_ylabel("test error")
    axes[0][0].legend(fontsize=8)
    fig.tight_layout()
    makedirs(fig_dir, exist_ok=True)
    path = join(fig_dir, "acc-eff-complexity." + fmt)
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_width_scaling(logs, fig_dir="figures", fmt="pdf"):
    """Width-scaled variants (cifar10-{sr,ac}-{fat,fatter}) when present
    (reference make-acc-eff-plots:205-236)."""
    mocs, errs = acc_eff_points(logs)
    widths = [("", "1x"), ("-fat", "2x"), ("-fatter", "4x")]
    present = [(suf, lab) for suf, lab in widths
               if logs.get(f"cifar10-sr{suf}") or logs.get(f"cifar10-ac{suf}")]
    if len(present) <= 1:
        return None
    fig, axes = plt.subplots(1, len(present),
                             figsize=(3.0 * len(present), 2.8),
                             squeeze=False)
    for ax, (suf, lab) in zip(axes[0], present):
        for name, c in ((f"cifar10-sr{suf}", "b"), (f"cifar10-ac{suf}", "r")):
            if logs.get(name):
                _curve(ax, mocs[name], errs[name], c=c)
        ax.set_title(f"width {lab}")
        ax.set_xlabel("mean op count")
    axes[0][0].set_ylabel("test error")
    fig.tight_layout()
    makedirs(fig_dir, exist_ok=True)
    path = join(fig_dir, "acc-eff-width." + fmt)
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_all_experiments(logs, fig_dir="figures", fmt="pdf"):
    """Fallback overview: every experiment's (moc, err) curve on one axis
    (useful for partial or non-canonical runs, e.g. the synth smoke sets)."""
    mocs, errs = acc_eff_points(logs)
    names = [n for n in sorted(logs) if logs[n]]
    if not names:
        return None
    fig, ax = plt.subplots(figsize=(4.5, 3.5))
    for name in names:
        _curve(ax, mocs[name], errs[name], label=name)
    ax.set_xlabel("mean op count")
    ax.set_ylabel("test error")
    ax.legend(fontsize=7)
    fig.tight_layout()
    makedirs(fig_dir, exist_ok=True)
    path = join(fig_dir, "acc-eff-all." + fmt)
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_single_comparison(logs, name_a, name_b, out_path, labels=None):
    """One-panel comparison used by make-pres-figs
    (reference make-pres-figs:56-326)."""
    mocs, errs = acc_eff_points(logs)
    fig, ax = plt.subplots(figsize=(3.2, 2.8))
    la, lb = labels or (name_a, name_b)
    if logs.get(name_a):
        _curve(ax, mocs[name_a], errs[name_a], c="b", label=la)
    if logs.get(name_b):
        _curve(ax, mocs[name_b], errs[name_b], c="r", label=lb)
    ax.set_xlabel("mean op count")
    ax.set_ylabel("test error")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
