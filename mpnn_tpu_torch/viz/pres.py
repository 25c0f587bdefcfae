"""Presentation-figure set: the reference's bespoke inventory, figure by
figure (reference scripts/make-pres-figs:56-326).

Sequentially-numbered SVGs under `figures/pres/%.2i.svg` (reference
make-pres-figs:45-50): nine styled single/multi-comparison acc-eff plots,
one three-panel width figure, and the four-panel routing-histogram heatmap.
A figure whose experiments are absent from `nets/` is skipped (the
reference would crash; a partial campaign should still render what it can),
so with a full campaign directory the output count and numbering match the
reference exactly.

Styling matches the reference: seaborn ticks style, serif fonts, the
reference's axis limits/ticks (mathtext instead of full usetex -- no TeX
install needed; same rendered labels)."""

from os import makedirs
from os.path import join

import numpy as np
import matplotlib
matplotlib.use("Agg")
import matplotlib.lines as lns
import matplotlib.pyplot as plt

from . import loading

try:
    import seaborn as sns
except ImportError:  # pragma: no cover - seaborn is in the image
    sns = None

# The reference's hybrid-figure frame (make-pres-figs:62-67 et al.).
HYB_XLIM = (0, 2.25e7)
HYB_XTICKS = ([0, 1e7, 2e7], ["$0$", r"$1{\times}10^7$", r"$2{\times}10^7$"])
HYB_YLIM = (0.015, 0.065)
HYB_YTICKS = [0.02, 0.04, 0.06]

SR_LBL = "Statically-Routed Nets"
AC_LBL = "Actor Nets"
CR_LBL = "Critic Nets"


def _style():
    if sns is not None:
        sns.set_style("ticks")
        sns.set_color_codes()
    plt.rcParams["font.family"] = "serif"


def _despine():
    if sns is not None:
        sns.despine()


def _save(path):
    plt.tight_layout()
    _despine()
    plt.savefig(path)
    plt.close()
    return path


def _series(stats, name):
    mocs, errs = stats
    return mocs[name], errs[name]


def _comparison_fig(stats, series, path, frame=True, auto_lim=False):
    """One styled acc-eff comparison (reference make-pres-figs:56-70 shape).

    series: [(expt_name, color, linestyle, label), ...]."""
    plt.figure(figsize=(5, 3.5))
    plt.xlabel("Mean Op Count")
    plt.ylabel("Error Rate")
    for name, color, ls, label in series:
        plt.plot(*_series(stats, name), ls, c=color, label=label)
    if frame and not auto_lim:
        plt.xlim(*HYB_XLIM)
        plt.xticks(*HYB_XTICKS)
        plt.ylim(*HYB_YLIM)
        plt.yticks(HYB_YTICKS)
    plt.legend()
    return _save(path)


def _complexity_fig(stats, path, loglog=False, auto_lim=False):
    """CIFAR-10/5/2 SR-vs-AC comparison, Paired palette
    (make-pres-figs:73-104: linear frame + a loglog variant)."""
    c = (sns.color_palette("Paired") if sns is not None
         else plt.get_cmap("Paired").colors)
    plt.figure(figsize=(5, 3.5))
    plt.xlabel("Mean Op Count")
    plt.ylabel("Error Rate")
    draw = plt.loglog if loglog else plt.plot
    for name, ci, label in [
            ("cifar10-sr", 1, "CIFAR-10: " + SR_LBL),
            ("cifar10-ac", 0, "CIFAR-10: " + AC_LBL),
            ("cifar5-sr", 3, "CIFAR-5: " + SR_LBL),
            ("cifar5-ac", 2, "CIFAR-5: " + AC_LBL),
            ("cifar2-sr", 5, "CIFAR-2: " + SR_LBL),
            ("cifar2-ac", 4, "CIFAR-2: " + AC_LBL)]:
        draw(*_series(stats, name), c=c[ci], label=label)
    if not loglog and not auto_lim:
        plt.xlim(*HYB_XLIM)
        plt.xticks(*HYB_XTICKS)
        plt.ylim(0, 0.3)
        plt.yticks([0.0, 0.1, 0.2, 0.3])
    plt.legend()
    return _save(path)


def _width_fig(stats, path):
    """Three width-tier panels (make-pres-figs:225-267)."""
    plt.figure(figsize=(5, 2))
    panels = [
        (r"$16 \leq n_\mathrm{chan} \leq 128$", "cifar10-sr", "cifar10-ac",
         [0, 2e7], ["$0$", r"$2{\times}10^7$"]),
        (r"$32 \leq n_\mathrm{chan} \leq 256$", "cifar10-sr-fat",
         "cifar10-ac-fat", [0, 8e7], ["$0$", r"$8{\times}10^7$"]),
        (r"$48 \leq n_\mathrm{chan} \leq 384$", "cifar10-sr-fatter",
         "cifar10-ac-fatter", [0, 1.8e8], ["$0$", r"$1.8{\times}10^8$"]),
    ]
    for i, (title, sr, ac, xt, xtl) in enumerate(panels):
        plt.subplot(1, 3, i + 1)
        plt.title(title, fontsize="small")
        if i == 0:
            plt.ylabel("Error Rate")
        if i == 1:
            plt.xlabel("Mean Op Count")
        plt.plot(*_series(stats, sr), c="b")
        plt.plot(*_series(stats, ac), c="g")
        plt.xticks(xt, xtl)
    plt.figlegend(
        [lns.Line2D([], [], color="b"), lns.Line2D([], [], color="g")],
        [SR_LBL, AC_LBL], loc=(0.0, 0), fontsize="x-small")
    plt.tight_layout(pad=0.1)
    plt.subplots_adjust(bottom=0.35)
    _despine()
    plt.savefig(path)
    plt.close()
    return path


def _routing_hist_fig(nets_dir, path, expt="hybrid-ac", k_labels=None):
    """Four-panel epoch-by-layer stopping-mass heatmap for nets 0-3
    (make-pres-figs:272-326): rows = epochs newest-first, hot colormap."""
    k_labels = k_labels or [r"$k_\mathrm{cpt}=0$",
                            r"$k_\mathrm{cpt}=1{\times}10^{-9}$",
                            r"$k_\mathrm{cpt}=2{\times}10^{-9}$",
                            r"$k_\mathrm{cpt}=4{\times}10^{-9}$"]
    histories = []
    for i in range(4):
        snaps = loading.load_snapshots(nets_dir, expt, i)
        if not snaps:
            return None
        rows = [loading.chain_stop_mass(d) for d in snaps]
        depth = max(len(r) for r in rows)
        m = np.zeros((len(rows), depth))
        for j, r in enumerate(rows):
            m[j, :len(r)] = r
        histories.append(m[::-1])  # newest epoch on top (reference :295)

    n_ep = histories[0].shape[0]
    plt.figure(figsize=(5, 3))
    for i, m in enumerate(histories):
        plt.subplot(1, 4, i + 1)
        plt.imshow(m, vmin=0, vmax=1, cmap="hot", aspect="auto")
        plt.title(k_labels[i], fontsize="x-small")
        plt.xticks([3, 7], ["4", "8"])
        if i == 0:
            # Rows are newest-first; label the middle and newest epochs
            # (reference make-pres-figs:292 labels rows 16/0 as 40k/80k).
            plt.yticks([n_ep // 2, 0],
                       [str(n_ep - n_ep // 2), str(n_ep)])
            plt.ylabel("Epoch Index")
        else:
            plt.yticks([])
    plt.tight_layout(pad=0)
    plt.colorbar(cax=plt.axes([0.9, 0.16, 0.025, 0.765]))
    plt.text(0.5, 0, "Layer Index", transform=plt.gcf().transFigure,
             va="bottom", ha="center", fontsize=11)
    plt.subplots_adjust(bottom=0.16, top=0.925, right=0.88)
    plt.savefig(path)
    plt.close()
    return path


# The reference's figure inventory in order (make-pres-figs:56-223).
# Each entry: (required experiment names, builder(stats, path)).
def _inventory(auto_lim):
    def cmp(series):
        return lambda stats, path: _comparison_fig(stats, series, path,
                                                   auto_lim=auto_lim)

    return [
        (["hybrid-sr", "hybrid-ac"], cmp([
            ("hybrid-sr", "b", "-", SR_LBL),
            ("hybrid-ac", "g", "-", AC_LBL)])),
        (["cifar10-sr", "cifar10-ac", "cifar5-sr", "cifar5-ac",
          "cifar2-sr", "cifar2-ac"],
         lambda stats, path: _complexity_fig(stats, path,
                                             auto_lim=auto_lim)),
        (["cifar10-sr", "cifar10-ac", "cifar5-sr", "cifar5-ac",
          "cifar2-sr", "cifar2-ac"],
         lambda stats, path: _complexity_fig(stats, path, loglog=True)),
        (["hybrid-sr", "hybrid-ac", "hybrid-cr"], cmp([
            ("hybrid-sr", "b", "-", SR_LBL),
            ("hybrid-ac", "g", "-", AC_LBL),
            ("hybrid-cr", "r", "-", CR_LBL)])),
        (["hybrid-sr", "hybrid-ac", "hybrid-ac-globopt"], cmp([
            ("hybrid-sr", "b", "-", SR_LBL),
            ("hybrid-ac", "g", "-", AC_LBL),
            ("hybrid-ac-globopt", "m", "-",
             "Actor Nets, Regularized Policy")])),
        (["hybrid-sr", "hybrid-ac", "hybrid-ac-nokdec"], cmp([
            ("hybrid-sr", "b", "-", SR_LBL),
            ("hybrid-ac", "g", "-", AC_LBL),
            ("hybrid-ac-nokdec", "g", ":",
             r"Actor Nets, $k_\mathrm{dec}=0$")])),
        (["hybrid-sr", "hybrid-ac", "hybrid-ac-notalr"], cmp([
            ("hybrid-sr", "b", "-", SR_LBL),
            ("hybrid-ac", "g", "-", AC_LBL),
            ("hybrid-ac-notalr", "g", "--", "Actor Nets, no TALR")])),
        (["hybrid-sr", "hybrid-cr", "hybrid-cr-notalr"], cmp([
            ("hybrid-sr", "b", "-", SR_LBL),
            ("hybrid-cr", "r", "-", CR_LBL),
            ("hybrid-cr-notalr", "r", "--", "Critic Nets, no TALR")])),
        (["hybrid-sr", "hybrid-ac", "hybrid-ac-tree"], cmp([
            ("hybrid-sr", "b", "-", SR_LBL),
            ("hybrid-ac", "g", "-", AC_LBL),
            ("hybrid-ac-tree", "c", "-", "Actor Nets, Branching")])),
        (["hybrid-sr", "hybrid-ac", "hybrid-ac-dynkcpt"], cmp([
            ("hybrid-sr", "b", "-", SR_LBL),
            ("hybrid-ac", "g", "-", AC_LBL),
            ("hybrid-ac-dynkcpt", "#8b4513", "-",
             r"Actor Net, Dynamic $k_\mathrm{cpt}$")])),
        (["cifar10-sr", "cifar10-ac", "cifar10-sr-fat", "cifar10-ac-fat",
          "cifar10-sr-fatter", "cifar10-ac-fatter"], _width_fig),
    ]


def make_pres_figs(nets_dir="nets", fig_dir="figures", auto_lim=False,
                   hist_expt=None, verbose=True):
    """Write the full presentation set; returns written paths.

    auto_lim=True drops the reference's hard-coded hybrid axis limits
    (useful when a stand-in dataset's error envelope differs from the
    paper's 0.015-0.065)."""
    _style()
    logs = loading.load_experiment_logs(nets_dir)
    stats = loading.acc_eff_points(logs)
    pres_dir = join(fig_dir, "pres")
    makedirs(pres_dir, exist_ok=True)

    written, fig_i = [], -1

    def next_path():
        nonlocal fig_i
        fig_i += 1
        return join(pres_dir, "%.2i.svg" % fig_i)

    for required, builder in _inventory(auto_lim):
        missing = [n for n in required if not logs.get(n)]
        if missing:
            if verbose:
                print("  [skipping a figure: no results for %s]"
                      % ", ".join(missing))
            continue
        written.append(builder(stats, next_path()))

    # Routing heatmap: explicit experiment, or the first candidate with
    # snapshot history (hybrid-ac, falling back to the synth smoke run).
    candidates = [hist_expt] if hist_expt else ["hybrid-ac", "synth-ac"]
    for expt in candidates:
        p = _routing_hist_fig(nets_dir, next_path(), expt=expt)
        if p:
            written.append(p)
            break
        fig_i -= 1  # figure not produced; reuse the number
        if verbose:
            print("  [skipping routing heatmap: no snapshot history for "
                  "nets 0-3 of %s]" % expt)
    return written
