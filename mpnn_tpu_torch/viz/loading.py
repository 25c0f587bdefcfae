"""Stats-file loading for the figure scripts.

Consumes the descriptor dicts written by the trainers -- the same glob
patterns as the reference figure scripts (scripts/make-acc-eff-plots:23-24,
make-routing-hists:15-16): `nets/<expt>/*-stats.npy` for final stats and
`nets/<expt>/<i>-stats/*.npy` for per-epoch snapshots."""

from glob import glob
from os import listdir
from os.path import isdir, join

import numpy as np


def load_experiment_logs(nets_dir="nets"):
    """{expt_name: [desc, ...]} for every experiment directory, sweep-sorted."""
    if not isdir(nets_dir):
        return {}
    return {
        name: [np.load(p, allow_pickle=True)[()]
               for p in sorted(glob(join(nets_dir, name, "*-stats.npy")))]
        for name in sorted(listdir(nets_dir))
        if isdir(join(nets_dir, name))}


def load_snapshots(nets_dir, expt, net_i=0):
    """Per-epoch descriptor snapshots for one net of one experiment."""
    paths = sorted(glob(join(nets_dir, expt, "%.4i-stats" % net_i, "*.npy")))
    return [np.load(p, allow_pickle=True)[()] for p in paths]


def acc_eff_points(logs):
    """(mocs, errs) per experiment from final stats
    (reference make-acc-eff-plots:25-28)."""
    errs = {name: [1 - d["stats_ts"]["acc"] for d in log]
            for name, log in logs.items()}
    mocs = {name: [d["stats_ts"]["moc"] for d in log]
            for name, log in logs.items()}
    return mocs, errs


def chain_stop_mass(desc, split="stats_ts", max_depth=8):
    """Per-layer stopping mass p_cor+p_inc down a chain descriptor, walking
    sinks[0]=leaf / sinks[1]=continue exactly like the reference
    (make-routing-hists:19-27)."""
    out = []
    node = desc["root"]["sinks"][0]
    for _ in range(max_depth):
        leaf = node["sinks"][0]
        out.append(leaf[split].get("p_cor", 0.0)
                   + leaf[split].get("p_inc", 0.0))
        if len(node["sinks"]) > 1:
            node = node["sinks"][1]
        else:
            break
    return out
