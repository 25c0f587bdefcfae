"""Snapshot campaign outputs into the committed results/ tree (counterpart
of `tools/archive_results.py`).

nets/, nets-stacked/ and figures/ are not committed (multi-GB
checkpoints). The compact artifacts the figures and the descriptor checks
read (per-experiment stats descriptors, MANIFEST.json provenance, logs,
the figures themselves) are a few MB and worth keeping: this tool copies
exactly those into results/, skipping checkpoints (NNNN.npy / net.npy)
and any file larger than --max-file-kb. It re-copies only what changed.

With --include-checkpoints the per-net checkpoints are archived too, up
to --ckpt-max-kb a file; a larger one becomes a compact '.cz' directory
(bfloat16 weights, zlib, parts of at most the cap each;
`utils.serdes.write_compact`). --restore plants the snapshots back under
the repo root where no live file exists (a '.cz' directory reassembled
into its checkpoint); --prune drops archived files whose source is gone.
Host-side: it touches no device, and writes the same files as the JAX
package's tool.

    python -m mpnn_tpu_torch.tools.archive_results [--roots nets nets-stacked]
"""

import argparse
import hashlib
import os
import pickle
import re
import shutil
import sys

import numpy as np

from ..utils import serdes

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CHECKPOINT_RE = re.compile(r"^(\d{4}\.npy|net\.npy)$")


def _want(path, name, max_kb, ckpt_max_kb=0):
    """Whether to archive a file: ckpt_max_kb = 0 excludes checkpoints;
    above 0 a checkpoint up to that size is copied and a larger one gives
    'compact' (archived by `_archive_compact`)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    if CHECKPOINT_RE.match(name):
        if ckpt_max_kb <= 0:
            return False
        if size > ckpt_max_kb * 1024:
            return "compact"
        return True
    return size <= max_kb * 1024


def _archive_compact(src, dst_dir, part_kb):
    """Archive an oversized checkpoint as a compact sharded directory;
    skipped (returns False) when the source hash matches the manifest."""
    src_sha = _hash(src).hex()
    if serdes.compact_src_sha(dst_dir) == src_sha:
        return False
    try:
        record = np.load(src, allow_pickle=True)[()]
    except (OSError, EOFError, ValueError, pickle.UnpicklingError) as e:
        # A torn mid-write checkpoint (or a foreign file with a
        # checkpoint's name) must not abort the whole archive pass.
        print("  [skip checkpoint over --ckpt-max-kb: %s — compact "
              "encode failed (%s)]" % (src, type(e).__name__))
        return False
    manifest = serdes.write_compact(dst_dir, record,
                                    part_bytes=part_kb * 1024,
                                    src_sha=src_sha)
    print("  [compact-archived %s -> %s (%d parts)]"
          % (src, dst_dir, len(manifest["parts"])))
    return True


def _hash(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.digest()


def _copy_if_changed(src, dst):
    try:
        s = os.stat(src)
    except OSError:
        return False
    try:
        d = os.stat(dst)
        # A strictly newer dst of equal size is current; an equal mtime
        # falls through to a content hash, so a same-size rewrite within
        # one mtime tick is still archived.
        if d.st_size == s.st_size:
            if d.st_mtime > s.st_mtime:
                return False
            if _hash(src) == _hash(dst):
                return False
    except OSError:
        pass
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copy2(src, dst)
    # copy2 keeps src's mtime; one ns past it lets the strictly-newer
    # fast path fire on the next pass, while a later rewrite of src gets
    # a fresh (higher) mtime and still reaches the hash check.
    st = os.stat(src)
    os.utime(dst, ns=(st.st_atime_ns, st.st_mtime_ns + 1))
    return True


def prune(roots, out_root, repo=REPO):
    """Remove archived files whose source no longer exists under the live
    roots. Only safe when the live roots are fully populated: on a fresh
    machine, before training re-created nets/, it would wipe the
    archive."""
    n = 0
    for root in roots:
        arch_root = os.path.join(out_root, root)
        if not os.path.isdir(arch_root):
            continue
        for dirpath, _, filenames in os.walk(arch_root, topdown=False):
            rel = os.path.relpath(dirpath, out_root)
            # Files inside a compact archive ('X.npy.cz/part-NN') never
            # exist live; their source is the directory name minus '.cz'.
            live = (os.path.join(repo, rel[:-3]) if rel.endswith(".cz")
                    else None)
            for name in filenames:
                src = live or os.path.join(repo, rel, name)
                if not os.path.exists(src):
                    os.remove(os.path.join(dirpath, name))
                    n += 1
            if not os.listdir(dirpath):
                os.rmdir(dirpath)
    return n


def archive(roots, out_root, max_kb, repo=REPO, ckpt_max_kb=0):
    """Copy the wanted files of each live root into out_root/<root>/.
    Returns (files copied or compacted, files unchanged)."""
    n_copied = n_kept = 0
    for root in roots:
        src_root = os.path.join(repo, root)
        if not os.path.isdir(src_root):
            continue
        for dirpath, dirnames, filenames in os.walk(src_root):
            dirnames[:] = [d for d in dirnames if d != "campaign-logs"]
            rel = os.path.relpath(dirpath, repo)
            for name in sorted(filenames):
                src = os.path.join(dirpath, name)
                want = _want(src, name, max_kb, ckpt_max_kb)
                if not want:
                    continue
                dst = os.path.join(out_root, rel, name)
                if want == "compact":
                    # Never leave both a plain copy and a .cz archive
                    # (restore reassembles .cz directories first).
                    if os.path.exists(dst):
                        os.remove(dst)
                    if _archive_compact(src, dst + ".cz", ckpt_max_kb):
                        n_copied += 1
                    else:
                        n_kept += 1
                else:
                    if CHECKPOINT_RE.match(name) and \
                            os.path.isdir(dst + ".cz"):
                        shutil.rmtree(dst + ".cz")
                    if _copy_if_changed(src, dst):
                        n_copied += 1
                    else:
                        n_kept += 1
    # Campaign logs: only the top-level timeline, not per-run stdout.
    for root in roots:
        log = os.path.join(repo, root, "campaign-logs", "campaign.log")
        if os.path.exists(log):
            if _copy_if_changed(log, os.path.join(
                    out_root, root, "campaign-logs", "campaign.log")):
                n_copied += 1
    return n_copied, n_kept


# The live roots the archiver snapshots into results/<root>/. restore()
# replants only these: results/ also holds artifacts that live there
# (bench-*.json, serving-frontier/, multichip/, cr-probe-*), which must
# not be copied to the repo root.
RESTORE_ROOTS = ("nets", "nets-stacked", "nets-probe",
                 "figures", "figures-stacked")


def restore(out_root, repo=REPO, roots=RESTORE_ROOTS):
    """Copy archived snapshots back under the repo root, never over a live
    file; a compact '.cz' directory becomes its checkpoint again (floats
    in float32). Only results/<root>/ for root in `roots` is replanted.
    Returns the number of files written."""
    n = 0
    if not os.path.isdir(out_root):
        return n
    walk = [p for r in roots
            for p in [os.path.join(out_root, r)] if os.path.isdir(p)]
    for dirpath, dirnames, filenames in (
            (d, dn, fn) for w in walk for d, dn, fn in os.walk(w)):
        rel = os.path.relpath(dirpath, out_root)
        for d in list(dirnames):
            if not d.endswith(".cz"):
                continue
            dirnames.remove(d)
            dst = os.path.join(repo, rel, d[:-3])
            if os.path.exists(dst):
                continue
            try:
                record = serdes.read_compact(os.path.join(dirpath, d))
            except (OSError, ValueError, KeyError, EOFError,
                    pickle.UnpicklingError) as e:
                print(f"  [compact restore FAILED for {d}: "
                      f"{type(e).__name__}: {e}]")
                continue
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            serdes.atomic_save(dst, record)
            n += 1
        for name in filenames:
            dst = os.path.join(repo, rel, name)
            if os.path.exists(dst):
                continue
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy2(os.path.join(dirpath, name), dst)
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--roots", nargs="*",
                   default=["nets", "nets-stacked", "figures",
                            "figures-stacked"])
    p.add_argument("--out", default=os.path.join(REPO, "results"))
    p.add_argument("--max-file-kb", type=int, default=512,
                   help="skip any single non-checkpoint file larger than "
                        "this")
    p.add_argument("--include-checkpoints", action="store_true",
                   help="also archive per-net experiment checkpoints "
                        "(NNNN.npy / net.npy) up to --ckpt-max-kb each; "
                        "call after an experiment completes, not from a "
                        "watcher loop")
    p.add_argument("--ckpt-max-kb", type=int, default=8192,
                   help="per-file size cap for --include-checkpoints "
                        "(default 8 MB: the base-width chains); larger "
                        "checkpoints are archived as bf16+zlib sharded "
                        "'.cz' directories whose parts each fit the cap")
    p.add_argument("--restore", action="store_true",
                   help="copy results/ back under the repo root (skips "
                        "files that already exist) instead of archiving")
    p.add_argument("--prune", action="store_true",
                   help="also delete archived files whose live source "
                        "is gone (only safe when the live roots are "
                        "fully populated)")
    args = p.parse_args(argv)
    if args.restore:
        n = restore(args.out)
        print(f"restored {n} files from "
              f"{os.path.relpath(args.out, os.getcwd())}")
        return 0
    if args.prune:
        n = prune(args.roots, args.out)
        print(f"pruned {n} stale archived files")
    n_copied, n_kept = archive(
        args.roots, args.out, args.max_file_kb,
        ckpt_max_kb=args.ckpt_max_kb if args.include_checkpoints else 0)
    print(f"archived {n_copied} new/changed files ({n_kept} unchanged) "
          f"-> {os.path.relpath(args.out, os.getcwd())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
