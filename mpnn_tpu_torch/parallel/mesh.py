"""Process meshes over `torch.distributed` (counterpart of
`mpnn_tpu/parallel/mesh.py`).

JAX lays a ('data', 'model') or ('sweep', 'data') grid over devices and
lets GSPMD partition one program. Here each rank is a process with one
device, as PyTorch runs data parallelism, and a `Mesh` is this rank's
place in the grid: the size of each axis, the rank's index along it, and
the process group of the ranks that share its other coordinates. Ranks
lie on the grid in row-major order, as `mpnn_tpu` reshapes its device
list: rank = i0 * n1 + i1.

- 'data' splits a step's global batch. Every rank draws the global batch
  and keeps its rows (`Axis.rows`); the batch reductions of the step are
  made global through `all_reduce_sum` over the axis' group, so the step
  is the single-process step at the global batch (`models.steps`).
- 'sweep' splits a k_cpt sweep's nets: each rank steps its slice of the
  stacked members (`shard_sweep_tree`) with no collective between nets.
- 'model' (output channels sharded across ranks) is not ported:
  `make_mesh` refuses n_model > 1.

Params, state and velocity are replicas: `replicate_tree` broadcasts
rank 0's. An axis of one rank has no group and reduces nothing
(`Axis.reduces`); a process that never called `init_process_group` is a
mesh of one rank."""

import math

import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves, tree_map

__all__ = ["Axis", "Mesh", "make_mesh", "make_sweep_mesh", "replicate_tree",
           "shard_sweep_tree", "all_reduce_sum", "all_reduce_flat",
           "batch_mean", "batch_moments", "world", "world_axis"]

MODEL_AXIS_TODO = ("the 'model' axis (tensor parallelism) is not ported "
                   "yet (ROADMAP.md, item A9: a stage sharded over "
                   "channels needs a gather between scales inside "
                   "fused_mcm)")


def world():
    """(rank, world size) of this process: (0, 1) without a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Axis:
    """One axis of a mesh as this rank sees it: its `size`, this rank's
    `index` along it, and the `group` of the ranks that differ from this
    one only along it (None when nothing is reduced over it: an axis of
    one rank, or one that no step reduces over)."""

    def __init__(self, size, index, group=None):
        self.size, self.index, self.group = size, index, group

    @property
    def reduces(self):
        """True where the step's reductions run over this axis' group."""
        return self.group is not None

    def rows(self, n):
        """(lo, hi): this rank's rows of n, split evenly in rank order."""
        if n % self.size:
            raise ValueError("%d rows do not split over a %d-way axis"
                             % (n, self.size))
        k = n // self.size
        return self.index * k, (self.index + 1) * k


class Mesh:
    """This rank's place in a 2-D mesh of processes: `axis_names`,
    `shape` ({name: size}) and `axes` ({name: Axis})."""

    def __init__(self, axis_names, axes):
        self.axis_names = tuple(axis_names)
        self.axes = dict(zip(axis_names, axes))
        self.shape = {n: a.size for n, a in self.axes.items()}

    @property
    def data(self):
        """The 'data' axis, whose ranks share each step's batch."""
        return self.axes["data"]


def _grid(names, sizes, reduce_over):
    """The Mesh of this rank on a grid of `sizes` (row-major over the
    ranks); a group is made for each axis in `reduce_over` that has more
    than one rank (the whole process group where it spans every rank).
    Every rank must call this, in the same order, since `dist.new_group`
    is collective."""
    rank, n_world = world()
    if math.prod(sizes) != n_world:
        raise ValueError("a %s mesh of %s needs %d ranks, this run has %d"
                         % ("x".join(names), "x".join(map(str, sizes)),
                            math.prod(sizes), n_world))
    index = divmod(rank, sizes[1])
    axes = []
    for a, (name, size) in enumerate(zip(names, sizes)):
        group = None
        if name in reduce_over and size > 1:
            if size == n_world:
                group = dist.group.WORLD
            else:
                other = sizes[1 - a]
                for o in range(other):
                    ranks = ([o * sizes[1] + i for i in range(size)] if a
                             else [i * sizes[1] + o for i in range(size)])
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        group = g
        axes.append(Axis(size, index[a], group))
    return Mesh(names, axes)


def world_axis():
    """An Axis over every rank of the process group, reducing over it."""
    rank, n_world = world()
    return Axis(n_world, rank, dist.group.WORLD)


def make_mesh(n_data=None, n_model=1):
    """A ('data', 'model') mesh over every rank; by default all on
    'data'. n_model > 1 raises NotImplementedError (not ported)."""
    if n_model != 1:
        raise NotImplementedError(MODEL_AXIS_TODO)
    return _grid(("data", "model"), (n_data or world()[1], 1), ("data",))


def make_sweep_mesh(n_sweep=None, n_data=1):
    """A ('sweep', 'data') mesh for the k_cpt sweep: each rank trains its
    `n_nets / n_sweep` members (`shard_sweep_tree`), a 'data' axis over 1
    splitting each member's batch. By default every rank on 'sweep'."""
    n_world = world()[1]
    if n_sweep is None:
        n_sweep = n_world // n_data
    return _grid(("sweep", "data"), (n_sweep, n_data), ("data",))


def replicate_tree(tree, mesh):
    """Every leaf of `tree` set to rank 0's values, in place, one
    broadcast per dtype over all ranks; returns tree. The identity on a
    mesh of one rank."""
    if world()[1] == 1:
        return tree
    leaves = tree_leaves(tree)
    for dt in dict.fromkeys(leaf.dtype for leaf in leaves):
        same = [leaf for leaf in leaves if leaf.dtype == dt]
        flat = torch.cat([leaf.reshape(-1) for leaf in same])
        dist.broadcast(flat, src=0)
        for leaf, part in zip(same, flat.split([x.numel() for x in same])):
            leaf.copy_(part.view(leaf.shape))
    return tree


def shard_sweep_tree(tree, mesh):
    """This rank's slice of a stacked sweep tree (members on the leading
    axis): the members of its 'sweep' index, copied out of the stack."""
    def part(a):
        lo, hi = mesh.axes["sweep"].rows(a.shape[0])
        return a[lo:hi].clone()
    return tree_map(part, tree)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group, differentiable: the backward sums the
    gradients over the group too, since each rank's input reaches every
    rank's output. Its vmap rule reduces the batched tensor whole (the
    members of the sweep's vmap at once), as `fused_mcm`'s rule launches
    once for every member."""

    @staticmethod
    def forward(t, group):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, t, group):
        return _AllReduceSum.apply(t, group), in_dims[0]


def all_reduce_sum(t, axis):
    """t summed over the ranks of `axis`, with its gradient; t itself
    where there is no axis or it reduces nothing."""
    if axis is None or not axis.reduces:
        return t
    return _AllReduceSum.apply(t, axis.group)


def batch_mean(v, axis):
    """The loss's mean over the batch, v (B,) per example: torch.mean
    without a data axis; under one, this rank's share of the global
    batch's mean, sum(v) / global B. The shares add up to the mean; the
    step adds them in its one all-reduce (`models.steps`)."""
    if axis is None or not axis.reduces:
        return torch.mean(v)
    return torch.sum(v) / (v.shape[0] * axis.size)


def batch_moments(xf, dims, axis):
    """(mean, E[x²] - mean²) of xf over `dims` (every dim but the
    channels), over the global batch under a data axis: this rank's sums
    of x and x², one all-reduce of both, over the global count. xf is
    fp32, and stays so across the reduction."""
    if axis is None or not axis.reduces:
        m = torch.mean(xf, dims)
        return m, torch.mean(torch.square(xf), dims) - torch.square(m)
    n = math.prod(xf.shape[d] for d in dims) * axis.size
    s = all_reduce_sum(torch.stack([torch.sum(xf, dims),
                                    torch.sum(torch.square(xf), dims)]),
                       axis) / n
    return s[0], s[1] - torch.square(s[0])


def all_reduce_flat(axis, sums, rows=()):
    """One all-reduce over `axis` of a flat fp32 bucket: each tensor of
    `sums` summed over the ranks; each of `rows` (batch on its last axis)
    gathered, the ranks' rows in rank order (each rank fills its block of
    zeros: gloo has no all_gather of CUDA tensors). Returns (sums, rows),
    each in its tensor's shape and dtype. A failed collective raises."""
    n, i = axis.size, axis.index
    n_sum = sum(t.numel() for t in sums)
    n_row = sum(t.numel() for t in rows)
    dev = (list(sums) + list(rows))[0].device
    parts = [t.reshape(-1).float() for t in sums]
    parts.append(torch.zeros(i * n_row, device=dev))
    parts += [t.reshape(-1).float() for t in rows]
    parts.append(torch.zeros((n - 1 - i) * n_row, device=dev))
    buf = torch.cat(parts)
    dist.all_reduce(buf, group=axis.group)
    out_sums, off = [], 0
    for t in sums:
        out_sums.append(buf[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    block = buf[n_sum:].view(n, n_row)
    out_rows, off = [], 0
    for t in rows:
        b = block[:, off:off + t.numel()].reshape((n,) + tuple(t.shape))
        out_rows.append(b.movedim(0, -2).reshape(
            tuple(t.shape[:-1]) + (n * t.shape[-1],)).to(t.dtype))
        off += t.numel()
    return out_sums, out_rows
