"""Divergence retry policy for campaign experiments (counterpart of
`tools/retrain_diverged.py`).

A few sweep members die at the reference's lr = 0.1 with some seeds (test
error pinned at chance from the first evaluation) and train well with
another seed. The reference's figures hold no dead nets, so the published
panels should not either. The policy:

  1. Scan each experiment's final per-net stats (`NNNN-stats.npy`) for
     members whose test accuracy is below chance + 5 points (chance = 1 /
     the class count, read from the descriptor's own p_cor_by_cls). A
     member whose stats a previous, interrupted retry preserved (a
     `NNNN-stats-diverged-*` file and no `NNNN-stats.npy`) counts as dead
     too, so an aborted retrain leaves no hidden hole.
  2. Keep the evidence: stats -> `NNNN-stats-diverged-seed<s>.npy`, log ->
     `NNNN-log-diverged-seed<s>.txt`, in the output root and in its
     `results/` mirror; the figure CLIs read only `NNNN-stats.npy`.
  3. Retrain that member alone, in a fresh process of
     `python -m mpnn_tpu_torch.train`, with the experiment seed bumped by
     100 per attempt (net i then starts from seed 100 * attempt + i), at
     the same budget.
  4. Scan again; at most --max-attempts (default 2) bumps.

    python -m mpnn_tpu_torch.tools.retrain_diverged [expt ...] [--dry-run]

With no names it scans every registry experiment with a directory under
--out-root. The retrains take the training CLI's own device (the card
by default); `--train-arg=--device=cpu` passes another through.
"""

import argparse
import glob
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def n_classes(desc):
    """Class count straight from the descriptor (the first p_cor_by_cls in
    the sink tree), so the chance level needs no dataset."""
    stack = [desc["root"]] if "root" in desc else []
    while stack:
        node = stack.pop()
        for sk in ("stats_tr", "stats_ts"):
            by_cls = node.get(sk, {}).get("p_cor_by_cls")
            if by_cls is not None:
                return len(by_cls)
        stack.extend(node.get("sinks", []))
    return None


def diverged_members(expt_dir):
    """[(index, acc_ts, n_cls)] of members whose final test accuracy is
    below chance + 5 points, and of members left as holes by an
    interrupted retry (preserved `-diverged-` stats, no canonical stats
    file; reported with the newest preserved trajectory)."""
    indices = set()
    for path in glob.glob(os.path.join(expt_dir, "[0-9]*-stats.npy")):
        m = re.match(r"(\d{4})-stats\.npy$", os.path.basename(path))
        if m:
            indices.add(int(m.group(1)))
    for path in glob.glob(os.path.join(expt_dir,
                                       "[0-9]*-stats-diverged-*.npy")):
        m = re.match(r"(\d{4})-stats-diverged-", os.path.basename(path))
        if m:
            indices.add(int(m.group(1)))
    out = []
    for i in sorted(indices):
        path = os.path.join(expt_dir, "%.4i-stats.npy" % i)
        hole = not os.path.exists(path)
        if hole:
            preserved = sorted(glob.glob(os.path.join(
                expt_dir, "%.4i-stats-diverged-*.npy" % i)))
            if not preserved:
                continue
            path = preserved[-1]
        desc = np.load(path, allow_pickle=True).item()
        acc = float(desc["stats_ts"]["acc"])
        n_cls = n_classes(desc)
        if n_cls and (acc < 1.0 / n_cls + 0.05 or hole):
            out.append((i, acc, n_cls))
    return out


def preserve_diverged(expt_dir, i, seed):
    """Rename the dead member's stats and log out of the figure CLIs'
    glob, keeping them on record, and drop its checkpoint; the same moves
    in the committed `results/` mirror of the experiment (where expt_dir
    lies under an output root with a sibling `results/<root>/`), so a
    later `archive_results --restore` cannot bring the dead member back."""
    moves = [("%.4i-stats.npy" % i,
              "%.4i-stats-diverged-seed%i.npy" % (i, seed)),
             ("%.4i-log.txt" % i, "%.4i-log-diverged-seed%i.txt" % (i, seed)),
             ("%.4i-stats" % i, "%.4i-stats-diverged-seed%i" % (i, seed))]
    out_root = os.path.dirname(os.path.abspath(expt_dir))
    mirror = os.path.join(os.path.dirname(out_root), "results",
                          os.path.basename(out_root),
                          os.path.basename(expt_dir))
    for base in (expt_dir, mirror):
        if not os.path.isdir(base):
            continue
        for src, dst in moves:
            s, d = os.path.join(base, src), os.path.join(base, dst)
            if os.path.exists(s) and not os.path.exists(d):
                os.rename(s, d)
        ckpt = os.path.join(base, "%.4i.npy" % i)
        if os.path.exists(ckpt):
            os.remove(ckpt)


def retrain(expt_name, indices, seed, out_root, n_iter=None,
            train_args=()):
    """Retrain the members in a fresh process of the training CLI, so each
    retry takes exactly the campaign's configuration path."""
    cmd = [sys.executable, "-m", "mpnn_tpu_torch.train", expt_name,
           "--seed", str(seed), "--out-root", out_root]
    for i in indices:
        cmd += ["--net", str(i)]
    if n_iter is not None:
        cmd += ["--n-iter", str(n_iter)]
    cmd += list(train_args)
    subprocess.run(cmd, check=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("expts", nargs="*",
                   help="experiment names (default: every registry "
                        "experiment with a directory under --out-root)")
    p.add_argument("--out-root", default=os.path.join(REPO, "nets"))
    p.add_argument("--n-iter", type=int, default=None,
                   help="override budget (default: registry 80k)")
    p.add_argument("--max-attempts", type=int, default=2)
    p.add_argument("--dry-run", action="store_true",
                   help="report dead members, change nothing")
    p.add_argument("--train-arg", action="append", dest="train_args",
                   default=None,
                   help="extra training CLI flag per use (default: "
                        "--precision bf16 --analytic-l2, the campaign "
                        "config)")
    args = p.parse_args(argv)
    from .. import experiments as cfg
    train_args = (args.train_args if args.train_args is not None
                  else ["--precision", "bf16", "--analytic-l2"])

    registry = cfg.make_experiments()
    names = args.expts or sorted(
        n for n in registry
        if os.path.isdir(os.path.join(args.out_root, n)))

    any_retrained = False
    for name in names:
        if name not in registry:
            print("skip %s: not a train-nets registry experiment" % name)
            continue
        expt_dir = os.path.join(args.out_root, name)
        for attempt in range(1, args.max_attempts + 1):
            dead = diverged_members(expt_dir)
            if not dead:
                break
            seed = 100 * attempt
            for i, acc, n_cls in dead:
                print("%s net %i: acc_ts %.4f < 1.5/%i chance -> %s "
                      "retry with seed %i"
                      % (name, i, acc, n_cls,
                         "would" if args.dry_run else "will", seed + i))
            if args.dry_run:
                break
            prev_seed = 100 * (attempt - 1)
            for i, _, _ in dead:
                preserve_diverged(expt_dir, i, prev_seed + i)
            retrain(name, [i for i, _, _ in dead], seed, args.out_root,
                    n_iter=args.n_iter, train_args=train_args)
            any_retrained = True
        else:
            if not args.dry_run and diverged_members(expt_dir):
                print("%s: still has dead members after %i attempts"
                      % (name, args.max_attempts))
    if args.dry_run or not any_retrained:
        print("done (no retraining performed)" if not any_retrained
              else "done")
    else:
        print("done; re-run the figures and `python -m "
              "mpnn_tpu_torch.tools.archive_results --include-checkpoints` "
              "to publish")
    return 0


if __name__ == "__main__":
    sys.exit(main())
