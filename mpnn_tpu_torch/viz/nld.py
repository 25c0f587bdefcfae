"""Node-link diagrams: the routing tree as nested pie-chart nodes.

Counterpart of reference scripts/make-nlds (and the per-epoch frame
generator scripts/make-videos). Each tree node is drawn as a circle whose
area encodes the evaluation-time probability mass stopping there
(radius ~ sqrt(p_cor + p_inc), reference make-nlds:46-229); the circle is a
pie of blue (correct) vs red (incorrect) mass, or per-class hues in the
by-class variant. Edges connect each node to its sinks; chains render as
vertical ladders, trees as recursive layouts."""

from os import makedirs
from os.path import join

import numpy as np
import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.patches import Wedge, Circle  # noqa: E402
import seaborn as sns  # noqa: E402


def _leaf_stats(node, split):
    p_cor = node[split].get("p_cor")
    p_inc = node[split].get("p_inc")
    return p_cor, p_inc


def _tree_width(desc):
    if not desc["sinks"]:
        return 1.0
    return max(1.0, sum(_tree_width(s) for s in desc["sinks"]))


def _tree_depth(desc):
    if not desc["sinks"]:
        return 0
    return 1 + max(_tree_depth(s) for s in desc["sinks"])


def _fig_dims(desc):
    """Per-net figure size scaled to the topology: wide branching trees
    (the reference's dr_tree has 48 leaf slots) get proportionally wider
    canvases so the pie nodes stay legible; chains keep the compact
    column the reference's chain grids use."""
    tw = _tree_width(desc["root"])
    td = _tree_depth(desc["root"])
    w = max(1.6, 0.26 * tw)
    # Content is drawn with equal aspect (tw x td data units): match the
    # canvas to it so wide trees don't sit in tall empty rows.
    h = max(2.4, w * (td + 1.5) / (tw + 1.5) + 0.4)
    return w, h


def _layout(desc, x0, x1, depth, pos):
    """Assign (x, -depth) positions; subtree widths set horizontal spans."""
    x = (x0 + x1) / 2
    pos.append((desc, x, -depth))
    if desc["sinks"]:
        widths = [_tree_width(s) for s in desc["sinks"]]
        total = sum(widths)
        cur = x0
        for s, w in zip(desc["sinks"], widths):
            span = (x1 - x0) * w / total
            _layout(s, cur, cur + span, depth + 1, pos)
            cur += span
    return pos


def _draw_node(ax, x, y, node, split, r_max=0.42, by_class=False,
               n_cls=None):
    p_cor, p_inc = _leaf_stats(node, split)
    if p_cor is None:  # interior node: small neutral dot
        ax.add_patch(Circle((x, y), 0.06, color="0.55", zorder=3))
        return
    mass = float(p_cor) + float(p_inc)
    r = r_max * np.sqrt(max(mass, 0.0))
    if r <= 1e-4:
        ax.add_patch(Circle((x, y), 0.02, color="0.8", zorder=3))
        return
    if by_class and "p_cor_by_cls" in node[split]:
        pc = np.asarray(node[split]["p_cor_by_cls"], float)
        pi = np.asarray(node[split]["p_inc_by_cls"], float)
        fracs = np.concatenate([pc, pi])
        n = len(pc)
        colors = (sns.color_palette("hls", n)
                  + [tuple(0.35 + 0.65 * np.array(c))
                     for c in sns.color_palette("hls", n)])
    else:
        fracs = np.asarray([float(p_cor), float(p_inc)])
        colors = ["#3465a4", "#cc0000"]
    total = fracs.sum()
    if total <= 0:
        return
    theta = 90.0
    for f, c in zip(fracs, colors):
        if f <= 0:
            continue
        dtheta = 360.0 * f / total
        ax.add_patch(Wedge((x, y), r, theta, theta + dtheta,
                           facecolor=c, edgecolor="none", zorder=3))
        theta += dtheta
    ax.add_patch(Circle((x, y), r, fill=False, color="0.3", lw=0.5,
                        zorder=4))


def draw_net(ax, desc, split="stats_ts", by_class=False):
    """Draw one network descriptor as a node-link diagram on ax."""
    pos = _layout(desc["root"], 0.0, max(_tree_width(desc["root"]), 1.0),
                  0, [])
    coords = {id(d): (x, y) for d, x, y in pos}
    for d, x, y in pos:
        for s in d["sinks"]:
            xs, ys = coords[id(s)]
            ax.plot([x, xs], [y, ys], c="0.75", lw=0.8, zorder=1)
    for d, x, y in pos:
        _draw_node(ax, x, y, d, split, by_class=by_class)
    ax.set_aspect("equal")
    ax.axis("off")
    xs = [x for _, x, _ in pos]
    ys = [y for _, _, y in pos]
    ax.set_xlim(min(xs) - 0.6, max(xs) + 0.6)
    ax.set_ylim(min(ys) - 0.6, max(ys) + 0.6)


def render_experiment_grid(logs, expt, out_path, split="stats_ts",
                           by_class=False):
    """One column per net of the sweep (reference chain grids)."""
    descs = logs.get(expt)
    if not descs:
        return None
    # Heterogeneous sweeps (the SR depth ladder) mix topology sizes: size
    # every cell for the largest net so deep chains stay legible.
    dims = [_fig_dims(d) for d in descs]
    w = max(d[0] for d in dims)
    h = max(d[1] for d in dims)
    n_cols = len(descs) if w * len(descs) <= 18 else max(1, int(18 // w))
    n_rows = -(-len(descs) // n_cols)
    fig, axes = plt.subplots(n_rows, n_cols,
                             figsize=(w * n_cols, h * n_rows),
                             squeeze=False)
    flat = [ax for row in axes for ax in row]
    for ax in flat[len(descs):]:
        ax.axis("off")
    for ax, desc in zip(flat, descs):
        draw_net(ax, desc, split, by_class)
    fig.suptitle(expt)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


# ---------------------------------------------------------------------------
# Reference-bespoke figures (scripts/make-nlds:42-234, ported 1:1 the way
# viz/pres.py ports make-pres-figs): the chain-grid and single-tree diagrams
# with the reference's exact node geometry — children fan out at angles
# a = ((i+1)/(n+1) - 1/2)·π with dx=cos(a), dy=r·sin(a) and radius decay
# r/len(sinks) (make-nlds:50-56,74-79) — plus its arrow annotations, axis
# captions, and legend patches. Deviations: usetex/serif rcParams are not
# forced (no TeX in this image), and chain grids take the max depth over
# ALL sweep members rather than net 0's (make-nlds:106 — identical for the
# homogeneous reference sweeps, robust for the SR depth ladder).

# The hybrid dataset's 10 classes: MNIST digits 0-4 + 5 CIFAR-10 classes
# (reference make-nlds:42-44).
CLS_LABELS = ["0", "1", "2", "3", "4",
              "Airplane", "Automobile", "Deer", "Frog", "Horse"]

# The reference renders under seaborn-classic's 'deep' palette where
# palette[0] is blue and palette[2] is red (make-nlds:68-69); pinned here so
# the output contract survives seaborn reorderings.
_COR_COLOR = "#4C72B0"
_INC_COLOR = "#C44E52"
_ARROW_KW = dict(fc="#909090", ec="#909090", linewidth=3, head_width=0.075)
_CAPTION_KW = dict(fontsize="large", color="#606060")


def _ref_bounds(node, x, y, r):
    """Bounding box of the reference layout (make-nlds:46-57)."""
    x0 = x1 = x
    y0 = y1 = y
    sinks = node["sinks"][1:]
    for i, s in enumerate(sinks):
        a = ((i + 1) / (len(sinks) + 1) - 0.5) * np.pi
        x2, x3, y2, y3 = _ref_bounds(s, x + np.cos(a), y + r * np.sin(a),
                                     r / len(sinks))
        x0 = min(x0, x2); x1 = max(x1, x3)  # noqa: E702
        y0 = min(y0, y2); y1 = max(y1, y3)  # noqa: E702
    return x0, x1, y0, y1


def _pie(ax, x, y, fracs, colors, radius):
    """plt.pie-equivalent wedges: counterclockwise from 90° like the
    reference's startangle=90 (make-nlds:65-73)."""
    fracs = np.asarray(fracs, float)
    total = fracs.sum()
    theta = 90.0
    for f, c in zip(fracs, colors):
        if f <= 0:
            continue
        d = 360.0 * f / total
        ax.add_patch(Wedge((x, y), radius, theta, theta + d,
                           facecolor=c, edgecolor="none", zorder=3))
        theta += d


def _draw_ref_nld(ax, node, x, y, r, by_class):
    """One subtree in the reference geometry (make-nlds:59-101): the node's
    pie shows its LEAF's (sinks[0]) stopping mass — area ∝ p_cor+p_inc,
    black dot below the 0.0025 floor — and edges continue into sinks[1:]."""
    leaf = node["sinks"][0]["stats_ts"]
    if by_class:
        fracs = [c + i for c, i in zip(leaf["p_cor_by_cls"],
                                       leaf["p_inc_by_cls"])]
        colors = sns.color_palette("hls", len(fracs))
    else:
        fracs = [leaf["p_cor"], leaf["p_inc"]]
        colors = [_COR_COLOR, _INC_COLOR]
    p_tot = float(np.sum(fracs))
    if p_tot > 0.0025:
        _pie(ax, x, y, fracs, colors, np.sqrt(p_tot) / 2)
    else:
        ax.add_patch(Circle((x, y), np.sqrt(0.0025) / 2, color="k",
                            zorder=3))
    sinks = node["sinks"][1:]
    for i, s in enumerate(sinks):
        a = ((i + 1) / (len(sinks) + 1) - 0.5) * np.pi
        x_s = x + np.cos(a)
        y_s = y + r * np.sin(a)
        ax.plot([x, x_s], [y, y_s], "k", linewidth=2, zorder=-1)
        _draw_ref_nld(ax, s, x_s, y_s, r / len(sinks), by_class)


def _acc_legend_patches():
    from matplotlib.patches import Patch
    return ([Patch(color=_COR_COLOR), Patch(color=_INC_COLOR)],
            ["Correct Labels", "Incorrect Labels"])


def _cls_label_list(n_cls, cls_labels=None):
    """Exactly n_cls legend labels: the named list truncated or padded with
    generic 'Class i' entries (descriptors can carry more classes than the
    10-name hybrid default)."""
    labels = list(cls_labels or CLS_LABELS)[:n_cls]
    labels += ["Class %d" % i for i in range(len(labels), n_cls)]
    return labels


def _cls_legend_patches(n_cls, cls_labels=None):
    from matplotlib.patches import Patch
    return ([Patch(color=c) for c in sns.color_palette("hls", n_cls)],
            _cls_label_list(n_cls, cls_labels))


def _n_cls(desc):
    node = desc["root"]["sinks"][0]
    while "p_cor_by_cls" not in node["stats_ts"]:
        node = node["sinks"][0]
    return len(node["stats_ts"]["p_cor_by_cls"])


def _chain_grid(descs, ax, by_class, x_off=0.0):
    """One net per row at (x_off, i) (make-nlds:107-108,131-132); returns
    the grid's max depth."""
    max_depth = max(_ref_bounds(d["root"]["sinks"][0], 0, 0, 1)[1]
                    for d in descs)
    for i, d in enumerate(descs):
        _draw_ref_nld(ax, d["root"]["sinks"][0], x_off, i, 1, by_class)
    return max_depth


def make_chain_acc_nld(descs, out_path):
    """Reference make_chain_acc_nld (make-nlds:103-125): sweep rows of
    correct/incorrect pies + cost/layer-index arrows + acc legend."""
    fig, ax = plt.subplots()
    n_nets = len(descs)
    max_depth = _chain_grid(descs, ax, by_class=False)
    ax.arrow(0.4 * max_depth, -0.6, 0.2 * max_depth, 0, **_ARROW_KW)
    ax.arrow(-0.6, 0.2 * (n_nets - 1), 0, 0.6 * (n_nets - 1), **_ARROW_KW)
    ax.set_ylabel("Cost of Computation", **_CAPTION_KW)
    ax.set_xlabel("Layer Index", **_CAPTION_KW)
    ax.set_xlim(-0.7, max_depth + 0.7)
    ax.set_ylim(-0.7, n_nets - 0.7)
    handles, labels = _acc_legend_patches()
    fig.legend(handles, labels, loc="lower right", fontsize="medium")
    ax.set_aspect("equal")
    fig.set_size_inches(max_depth + 2, n_nets + 0.7)
    fig.tight_layout()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def make_chain_cls_nld(descs, out_path, cls_labels=None):
    """Reference make_chain_cls_nld (make-nlds:127-148): per-class hue pies
    with the named 10-class legend."""
    fig, ax = plt.subplots()
    n_nets = len(descs)
    max_depth = _chain_grid(descs, ax, by_class=True)
    ax.arrow(0.4 * max_depth, -0.6, 0.2 * max_depth, 0, **_ARROW_KW)
    ax.arrow(-0.6, 0.2 * (n_nets - 1), 0, 0.6 * (n_nets - 1), **_ARROW_KW)
    ax.set_ylabel("Cost of Computation", **_CAPTION_KW)
    ax.set_xlabel("Layer Index", **_CAPTION_KW)
    ax.set_xlim(-0.7, max_depth + 0.7)
    ax.set_ylim(-0.7, n_nets - 0.7)
    handles, labels = _cls_legend_patches(_n_cls(descs[0]), cls_labels)
    fig.legend(handles, labels, loc="lower center", ncol=5,
               columnspacing=1, fontsize="medium")
    ax.set_aspect("equal")
    fig.set_size_inches(max_depth + 2, n_nets + 2)
    fig.tight_layout()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def _tree_nld(desc, out_path, by_class, cls_labels, legend_loc,
              legend_fontsize, xlabel_fontsize="large"):
    """Shared tree renderer (make-nlds:150-186): one net at radius 2 with a
    'Dataflow' arrow under the canvas."""
    fig, ax = plt.subplots()
    _draw_ref_nld(ax, desc["root"]["sinks"][0], 0, 0, 2, by_class)
    x0, x1, y0, y1 = _ref_bounds(desc["root"]["sinks"][0], 0, 0, 2)
    ax.arrow(0.35 * x1, y0 - 0.33, 0.3 * x1, 0, **_ARROW_KW)
    ax.set_xlabel("Dataflow", fontsize=xlabel_fontsize, color="#606060")
    ax.set_xlim(x0, x1)
    ax.set_ylim(y0 - 0.4, y1 + 0.05)
    if by_class:
        handles, labels = _cls_legend_patches(_n_cls(desc), cls_labels)
    else:
        handles, labels = _acc_legend_patches()
    fig.legend(handles, labels, loc=legend_loc, fontsize=legend_fontsize)
    ax.set_aspect("equal")
    fig.set_size_inches(x1 - x0 + 2, y1 - y0 + 2)
    fig.tight_layout()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def make_tree_acc_nld(desc, out_path):
    """Reference make_tree_acc_nld (make-nlds:150-168)."""
    return _tree_nld(desc, out_path, by_class=False, cls_labels=None,
                     legend_loc="lower right", legend_fontsize="small")


def make_tree_cls_nld(desc, out_path, cls_labels=None):
    """Reference make_tree_cls_nld (make-nlds:170-186)."""
    return _tree_nld(desc, out_path, by_class=True, cls_labels=cls_labels,
                     legend_loc="lower left", legend_fontsize="medium",
                     xlabel_fontsize="x-large")


def make_chain_acc_and_cls_nld(descs, out_path, cls_labels=None):
    """Reference make_chain_acc_and_cls_nld (make-nlds:188-229): the acc
    grid and the by-class grid side by side, per-grid layer-index arrows +
    captions drawn in data coordinates, and the two legends anchored under
    their own grids."""
    from matplotlib.patches import Patch
    fig, ax = plt.subplots()
    n_nets = len(descs)
    max_depth = _chain_grid(descs, ax, by_class=False)
    _chain_grid(descs, ax, by_class=True, x_off=max_depth + 1)
    ax.set_xlim(-0.9, 2 * max_depth + 1.9)
    ax.set_ylim(-1.7, n_nets - 0.7)
    ax.arrow(-0.7, 0.2 * (n_nets - 1), 0, 0.6 * (n_nets - 1), **_ARROW_KW)
    ax.text(-0.9, 0.5 * n_nets - 0.5, "Cost of Computation", va="center",
            ha="center", rotation="vertical", **_CAPTION_KW)
    ax.arrow(0.4 * max_depth, -0.5, 0.2 * max_depth, 0, **_ARROW_KW)
    ax.text(0.5 * max_depth, -0.725, "Layer Index", va="center",
            ha="center", **_CAPTION_KW)
    ax.arrow(1.4 * max_depth + 1, -0.5, 0.2 * max_depth, 0, **_ARROW_KW)
    ax.text(1.5 * max_depth + 1, -0.725, "Layer Index", va="center",
            ha="center", **_CAPTION_KW)
    ax.add_artist(ax.legend(
        handles=[Patch(color=_COR_COLOR, label="Correct Labels"),
                 Patch(color=_INC_COLOR, label="Incorrect Labels")],
        bbox_to_anchor=(0, -1.8, max_depth, 0),
        bbox_transform=ax.transData, loc="lower center",
        fontsize="large"))
    n_cls = _n_cls(descs[0])
    labels = _cls_label_list(n_cls, cls_labels)
    ax.add_artist(ax.legend(
        handles=[Patch(color=c, label=labels[i]) for i, c in
                 enumerate(sns.color_palette("hls", n_cls))],
        bbox_to_anchor=(max_depth + 1, -1.8, max_depth, 0),
        bbox_transform=ax.transData, loc="lower center",
        fontsize="large", ncol=5, columnspacing=1))
    ax.set_aspect("equal")
    fig.set_size_inches(2 * max_depth + 2, n_nets + 2)
    fig.tight_layout(pad=0)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


# The reference's emitted inventory (make-nlds:233-234): figure name ->
# (constructor kind, experiment, net index or None).
REFERENCE_NLDS = {
    "nld-0.pdf": ("chain_acc_and_cls", "hybrid-ac", None),
    "nld-1.pdf": ("tree_cls", "hybrid-ac-tree", 0),
}


def render_reference_nlds(logs, fig_dir, inventory=None):
    """Emit the reference's exact nld figure set (skip-missing, like
    viz/pres.py): nld-0.pdf = hybrid-ac chain acc+cls grid, nld-1.pdf =
    hybrid-ac-tree net-0 by-class tree."""
    makedirs(fig_dir, exist_ok=True)
    written = []
    for dst, (kind, expt, idx) in (inventory or REFERENCE_NLDS).items():
        descs = logs.get(expt)
        if not descs or (idx is not None and idx >= len(descs)):
            continue
        out = join(fig_dir, dst)
        if kind == "chain_acc_and_cls":
            make_chain_acc_and_cls_nld(descs, out)
        elif kind == "chain_acc":
            make_chain_acc_nld(descs, out)
        elif kind == "chain_cls":
            make_chain_cls_nld(descs, out)
        elif kind == "tree_acc":
            make_tree_acc_nld(descs[idx], out)
        elif kind == "tree_cls":
            make_tree_cls_nld(descs[idx], out)
        else:
            raise ValueError(kind)
        written.append(out)
    return written


def render_video_frames(snapshots, out_dir, split="stats_ts",
                        by_class=False):
    """Per-epoch frames (reference scripts/make-videos:258-277): one PNG per
    descriptor snapshot; assemble with assemble_gif (or externally)."""
    makedirs(out_dir, exist_ok=True)
    paths = []
    for i, desc in enumerate(snapshots):
        w, h = _fig_dims(desc)
        fig, ax = plt.subplots(figsize=(max(w, 3.2), max(h, 5.0)))
        draw_net(ax, desc, split, by_class)
        path = join(out_dir, "%03i.png" % i)
        fig.savefig(path, dpi=120)
        plt.close(fig)
        paths.append(path)
    return paths


def assemble_gif(frame_paths, out_path, ms_per_frame=250):
    """Assemble rendered frames into an animated GIF (the in-repo analogue
    of the video files reference make-videos produces from its frame
    sequences). Frames may differ slightly in size (tight bboxes); they are
    letterboxed onto the largest canvas."""
    if not frame_paths:
        return None
    from PIL import Image
    frames = [Image.open(p).convert("RGB") for p in frame_paths]
    w = max(f.width for f in frames)
    h = max(f.height for f in frames)
    canvas = []
    for f in frames:
        c = Image.new("RGB", (w, h), (255, 255, 255))
        c.paste(f, ((w - f.width) // 2, (h - f.height) // 2))
        canvas.append(c)
    canvas[0].save(out_path, save_all=True, append_images=canvas[1:],
                   duration=ms_per_frame, loop=0)
    return out_path
