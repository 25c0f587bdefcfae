"""The figures CLI: one subcommand per figure script of `mpnn_tpu`
(`scripts/make-acc-eff-plots`, `make-nlds`, `make-routing-hists`,
`make-pres-figs`, `make-videos`), with their flags and defaults, drawn by
`mpnn_tpu_torch.viz` from the descriptor files under --nets-dir:

    python -m mpnn_tpu_torch.figures acc-eff --nets-dir nets --fig-dir figures
    python -m mpnn_tpu_torch.figures nlds hybrid-ac hybrid-ac-tree
    python -m mpnn_tpu_torch.figures routing-hists hybrid-ac --nets 0 1 2 3
    python -m mpnn_tpu_torch.figures pres [--auto-lim] [--hist-expt E]
    python -m mpnn_tpu_torch.figures videos hybrid-ac --nets 0 --gif

Host-side work (numpy, matplotlib, seaborn; PIL for --gif): it runs on
the CPU and never touches a device. Where matplotlib is missing it raises
an ImportError that names it."""

import sys
from argparse import ArgumentParser
from os import makedirs
from os.path import join

__all__ = ["main"]


def _viz():
    """`mpnn_tpu_torch.viz`, or an ImportError that names what is
    missing."""
    try:
        from . import viz
    except ImportError as e:
        raise ImportError(
            "the figures need matplotlib and seaborn (and PIL for --gif), "
            "which this Python lacks (%s); render them on a host that has "
            "them" % e) from e
    return viz


def acc_eff(args):
    viz = _viz()
    logs = viz.loading.load_experiment_logs(args.nets_dir)
    if not logs:
        print("no stats found under %s" % args.nets_dir)
        return
    written = [p for p in (
        viz.acc_eff.plot_strategy_comparison(logs, args.fig_dir),
        viz.acc_eff.plot_complexity_comparison(logs, args.fig_dir),
        viz.acc_eff.plot_width_scaling(logs, args.fig_dir),
        viz.acc_eff.plot_all_experiments(logs, args.fig_dir)) if p]
    print("wrote: %s" % (", ".join(written) if written else "(nothing)"))


def nlds(args):
    viz = _viz()
    logs = viz.loading.load_experiment_logs(args.nets_dir)
    names = args.expts or sorted(logs)
    makedirs(args.fig_dir, exist_ok=True)
    written = []
    suffix = "-by-class" if args.by_class else ""
    for name in names:
        out = join(args.fig_dir, "nld-%s%s.pdf" % (name, suffix))
        if viz.nld.render_experiment_grid(logs, name, out,
                                          by_class=args.by_class):
            written.append(out)
    if not args.no_bespoke:
        # The reference's own inventory: nld-0.pdf (the hybrid-ac chain's
        # accuracy and class grid) and nld-1.pdf (hybrid-ac-tree net 0 by
        # class), each skipped where its experiment is missing.
        written += viz.nld.render_reference_nlds(logs, args.fig_dir)
    print("wrote: %s" % (", ".join(written) if written else "(nothing)"))


def routing_hists(args):
    viz = _viz()
    path = viz.routing.plot_routing_hists(args.nets_dir, args.expt,
                                          tuple(args.nets), args.fig_dir)
    print("wrote: %s" % (path or "(no snapshots found)"))


def pres(args):
    _viz()
    from .viz.pres import make_pres_figs
    written = make_pres_figs(args.nets_dir, args.fig_dir,
                             auto_lim=args.auto_lim,
                             hist_expt=args.hist_expt)
    print("wrote %i figures under %s"
          % (len(written), join(args.fig_dir, "pres")))


def videos(args):
    viz = _viz()
    total = 0
    for i in args.nets:
        snaps = viz.loading.load_snapshots(args.nets_dir, args.expt, i)
        if not snaps:
            continue
        out_dir = join(args.fig_dir, "videos", args.expt, "%.4i" % i)
        frames = viz.nld.render_video_frames(snaps, out_dir,
                                             by_class=args.by_class)
        total += len(frames)
        print("net %i: %i frames -> %s" % (i, len(frames), out_dir))
        if args.gif:
            gif = viz.nld.assemble_gif(frames, out_dir + ".gif",
                                       ms_per_frame=args.ms_per_frame)
            print("net %i: gif -> %s" % (i, gif))
    if total == 0:
        print("(no snapshots found)")


def _parser():
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="command", required=True)

    def command(name, fn, help):
        p = sub.add_parser(name, help=help)
        p.set_defaults(fn=fn)
        return p

    def dirs(p):
        p.add_argument("--nets-dir", default="nets")
        p.add_argument("--fig-dir", default="figures")

    p = command("acc-eff", acc_eff, "accuracy/efficiency plots: training "
                "strategies, dataset complexity, width scaling, all "
                "experiments, from nets/*/*-stats.npy")
    dirs(p)
    p = command("nlds", nlds, "node-link diagrams of every experiment (or "
                "those named)")
    p.add_argument("expts", nargs="*", default=None,
                   help="experiments to render (default: all found)")
    p.add_argument("--by-class", action="store_true")
    p.add_argument("--no-bespoke", action="store_true",
                   help="skip the reference's exact nld-0/nld-1 figure set")
    dirs(p)
    p = command("routing-hists", routing_hists, "epoch x depth "
                "stopping-mass heatmaps of a chain experiment's sweep")
    p.add_argument("expt", nargs="?", default="hybrid-ac")
    p.add_argument("--nets", type=int, nargs="*", default=[0, 1, 2, 3])
    dirs(p)
    p = command("pres", pres, "the presentation set, numbered SVGs under "
                "FIG_DIR/pres/")
    dirs(p)
    p.add_argument("--auto-lim", action="store_true",
                   help="fit axes to the data instead of the reference's "
                        "hybrid-paper limits (for stand-in datasets whose "
                        "error envelope differs)")
    p.add_argument("--hist-expt", default=None,
                   help="experiment for the routing-hist heatmap (default: "
                        "hybrid-ac, falling back to synth-ac)")
    p = command("videos", videos, "per-epoch node-link frames, one PNG a "
                "stats snapshot, under FIG_DIR/videos/EXPT/NNNN/")
    p.add_argument("expt")
    p.add_argument("--nets", type=int, nargs="*", default=[0])
    p.add_argument("--by-class", action="store_true")
    p.add_argument("--gif", action="store_true",
                   help="also assemble the frames into an animated GIF")
    p.add_argument("--ms-per-frame", type=int, default=250)
    dirs(p)
    return parser


def main(argv=None):
    args = _parser().parse_args(sys.argv[1:] if argv is None else argv)
    args.fn(args)


if __name__ == "__main__":
    main()
