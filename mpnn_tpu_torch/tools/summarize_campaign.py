"""Summarize campaign results (counterpart of
`tools/summarize_campaign.py`): one markdown table row per experiment
with the (moc, test err) sweep endpoints, and a family-relative outlier
check.

A member whose test err exceeds OUTLIER_X (3x) the sweep median is
flagged in its row with its identity: its k_cpt for cost sweeps (the
registry's sweep_k_cpts), its depth for SR depth sweeps. A flagged member
at one of the two most aggressive prices is annotated "aggressive price"
(high prices push routing to the cheapest exits, which costs accuracy);
the shallowest SR net is capacity-limited; a member whose seed+100 probe
retrain under `<nets-dir>-probe/` sits within the bar is seed
instability; any other is UNEXPLAINED and should be retried
(`mpnn_tpu_torch.tools.retrain_diverged`) or investigated. Host-side: it
reads descriptor files and touches no device.

    python -m mpnn_tpu_torch.tools.summarize_campaign [--nets-dir nets] [--full]
"""

import glob
import os
from argparse import ArgumentParser
from os.path import basename, join

import numpy as np

from ..experiments import k_cpts, make_experiments

OUTLIER_X = 3.0


def sweep_rows(nets_dir):
    """(experiment, [(member, moc, test err)]) per directory with final
    stats, in name order."""
    for expt in sorted(os.listdir(nets_dir)):
        files = sorted(glob.glob(join(nets_dir, expt, "*-stats.npy")))
        if not files:
            continue
        curve = []
        for f in files:
            d = np.load(f, allow_pickle=True)[()]
            curve.append((basename(f).split("-")[0],
                          float(d["stats_ts"]["moc"]),
                          1.0 - float(d["stats_ts"]["acc"])))
        yield expt, curve


def member_labels(expt, n):
    """Identity of each sweep member: k_cpt for cost sweeps, chain depth
    for SR depth sweeps (registry order is the file order). Returns
    (labels, {index: why its high err is expected})."""
    spec = make_experiments().get(expt)
    ks = getattr(spec, "sweep_k_cpts", None) if spec is not None else None
    if ks and len(ks) >= n:
        labels = [f"k_cpt={k:g}" for k in ks[:n]]
        order = np.argsort(ks[:n])
        return labels, {int(i): "aggressive price" for i in order[-2:]}
    if spec is not None and not ks:
        # SR depth sweeps: the shallowest net's high err is capacity,
        # not divergence.
        return ([f"depth={i + 1}" for i in range(n)],
                {0: "shallowest net (capacity-limited)"})
    # Adaptive directories (8 per-price snapshots of one net) and unknown
    # experiments: the reference's price order, for annotation only.
    if n == len(k_cpts):
        return ([f"k_cpt={k:g}" for k in k_cpts],
                {n - 2: "aggressive price", n - 1: "aggressive price"})
    return [f"member={i}" for i in range(n)], {}


def outliers(expt, curve, probe_dir=None):
    """The flags of a sweep's members above the bar. probe_dir: a sibling
    tree of seed+100 probe retrains (`nets-probe/`); a flagged member
    whose probe sits within the bar is annotated as seed instability
    instead of UNEXPLAINED."""
    errs = np.asarray([e for _, _, e in curve])
    med = float(np.median(errs))
    labels, expected = member_labels(expt, len(curve))
    flags = []
    for i, (name, _, err) in enumerate(curve):
        if med > 0 and err > OUTLIER_X * med:
            why = expected.get(i)
            if why is None and probe_dir:
                p = os.path.join(probe_dir, expt, f"{name}-stats.npy")
                if os.path.exists(p):
                    d = np.load(p, allow_pickle=True)[()]
                    perr = 1.0 - float(d["stats_ts"]["acc"])
                    why = (f"seed instability — seed+100 probe reaches "
                           f"err {perr:.3f} ({os.path.relpath(p)})"
                           if perr <= OUTLIER_X * med else
                           f"probe retrain ALSO high (err {perr:.3f}) — "
                           f"systematic, investigate")
            if why is None:
                why = "UNEXPLAINED — retry or investigate"
            flags.append(f"{name} ({labels[i]}): err {err:.3f} = "
                         f"{err / med:.1f}x median [{why}]")
    return flags


def main(argv=None):
    p = ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nets-dir", default="nets")
    p.add_argument("--full", action="store_true",
                   help="print every net of each sweep, not just endpoints")
    args = p.parse_args(argv)

    any_unexplained = False
    print("| experiment | nets | err range (test) | moc range | "
          f"outliers (>{OUTLIER_X:g}x median err) |")
    print("|---|---|---|---|---|")
    probe_dir = args.nets_dir.rstrip("/") + "-probe"
    for expt, curve in sweep_rows(args.nets_dir):
        errs = [e for _, _, e in curve]
        mocs = [m for _, m, _ in curve]
        flags = outliers(expt, curve, probe_dir=probe_dir)
        any_unexplained |= any("UNEXPLAINED" in f for f in flags)
        print(f"| {expt} | {len(curve)} | "
              f"{min(errs):.4f} – {max(errs):.4f} | "
              f"{min(mocs):.3g} – {max(mocs):.3g} | "
              f"{'; '.join(flags) if flags else 'none'} |")
    if args.full:
        for expt, curve in sweep_rows(args.nets_dir):
            labels, _ = member_labels(expt, len(curve))
            print(f"\n### {expt}")
            for (name, moc, err), lab in zip(curve, labels):
                print(f"  {name} ({lab}): err={err:.4f} moc={moc:.4g}")
    if any_unexplained:
        print("\nWARNING: unexplained outliers present (see rows above).")


if __name__ == "__main__":
    main()
