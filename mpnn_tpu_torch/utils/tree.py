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
    tree_map(out.append, tree)
    return out


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
