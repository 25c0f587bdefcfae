"""Maps over the port's parameter trees: nested dicts and lists whose
leaves are tensors (params, state, velocities and gradients share one
structure). Leaves are visited in one fixed order, dict insertion order
and list order, so `tree_leaves` and `tree_map` line up."""


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
