"""Maps over the port's parameter trees: nested dicts and lists whose
leaves are tensors (params, state, velocities and gradients share one
structure). Leaves are visited in one fixed order, dict insertion order
and list order, so `tree_leaves` and `tree_map` line up."""

import torch


def tree_map(fn, tree, *rest):
    """A tree of the same structure with fn(leaf, *matching leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *[r[i] for r in rest])
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of `tree`, in `tree_map`'s order."""
    out = []
    _collect(tree, out)
    return out


def _collect(tree, out):
    """Append the leaves of `tree` to `out` (a module-level function: a
    recursive closure would keep the leaves alive until the garbage
    collector ran)."""
    if isinstance(tree, dict):
        for v in tree.values():
            _collect(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect(v, out)
    else:
        out.append(tree)


def tree_paths(tree, prefix=""):
    """The '/'-joined keys and indices of each leaf of `tree`, in
    `tree_leaves`' order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in tree_paths(v, "%s%s/" % (prefix, k))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, "%s%d/" % (prefix, i))]
    return [prefix.rstrip("/")]


def stack_trees(trees):
    """Stack identically structured trees along a new leading axis (the
    net axis of `models.steps.make_sweep_train_loop`)."""
    return tree_map(lambda *a: torch.stack(a), *trees)


def unstack_tree(tree, i):
    """Member i of a stacked tree."""
    return tree_map(lambda a: a[i], tree)


def tree_to_host(tree):
    """`tree` with its leaves on the CPU, brought over in one copy per
    dtype (not one per leaf)."""
    leaves = tree_leaves(tree)
    host = [None] * len(leaves)
    for dt in {leaf.dtype for leaf in leaves}:
        idx = [i for i, leaf in enumerate(leaves) if leaf.dtype == dt]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx]).cpu()
        parts = flat.split([leaves[i].numel() for i in idx])
        for i, part in zip(idx, parts):
            host[i] = part.view(leaves[i].shape)
    it = iter(host)
    return tree_map(lambda _: next(it), tree)
