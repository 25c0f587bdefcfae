"""Routed sparse inference: skip the compute the router skips (counterpart
of `mpnn_tpu/models/infer.py`).

- Examples flow through the routing tree in fixed-capacity "active"
  buffers, one buffer size per tree edge.
- At each switch the router's argmax picks a sink per example (the dense
  pi_ev rule).
- Each child's selected examples are compacted to the front of its buffer
  by a stable argsort, so buffers fill in the same order as in `mpnn_tpu`,
  and the child subtree processes only that buffer.
- Internal children have capacity ceil(f * batch); selected examples beyond
  capacity are force-exited through the switch's early-exit leaf. f = 1.0
  reproduces dense hard routing exactly.
- Exited examples' class probabilities, exit leaf index and realized op
  count are written to their original batch rows. Padding rows of a buffer
  carry the index B and write to a sentinel row B of (B+1)-row outputs,
  which is sliced off: torch has no scatter mode that drops out-of-range
  indices.

Every switch that can overflow (f < 1) needs a leaf child to force-exit
through, which holds for every reference architecture."""

import math

import numpy as np
import torch

from .net import Ctx, _hyper, _subtree_nodes


def chain_stages(net):
    """Decompose a chain net into [(node, leaf_or_None, next_or_None)];
    raises ValueError for trees."""
    stages = []
    cur = net.root
    while True:
        if len(cur.sinks) == 0:
            stages.append((cur, None, None))
            return stages
        if len(cur.sinks) == 1:
            stages.append((cur, None, cur.sinks[0]))
            cur = cur.sinks[0]
        elif len(cur.sinks) == 2 and len(cur.sinks[0].sinks) == 0:
            stages.append((cur, cur.sinks[0], cur.sinks[1]))
            cur = cur.sinks[1]
        else:
            raise ValueError(
                "not a chain topology; got a node with sinks "
                f"{[s.name for s in cur.sinks]}")


def _gather_act(act, idx):
    if isinstance(act, list):
        return [a[idx] for a in act]
    return act[idx]


def _f32(v):
    """A Python float exactly representable in fp32, so adding it to an fp32
    tensor rounds as JAX's weakly typed scalar add does."""
    return float(np.float32(v))


def calibrate_capacities(net, params, state, x0, *, margin=1.5,
                         k_cpt=None, floor=1.0 / 64.0, grid=32):
    """Per-switch capacity fractions fitted to the trained routing
    distribution.

    Runs exact hard routing (capacity 1.0) on a calibration batch, measures
    each switch's worst internal-child arrival rate w.r.t. the original
    batch, and returns `min(1, max(floor, margin * rate))` per switch,
    rounded up to a multiple of 1/`grid` (stable buffer shapes across
    retrains), in the preorder switch order `make_routed_infer_fn` takes."""
    B = len(x0)
    infer = make_routed_infer_fn(net, B, capacities=1.0)
    exit_idx = infer(params, state, x0, k_cpt)["exit_idx"].cpu().numpy()
    leaves = list(net.leaves)
    fracs = []
    for sw in net.switches:
        worst = 0
        for sink in sw.sinks:
            if len(sink.sinks) == 0:
                continue
            sub = _subtree_nodes(sink)
            sub_leaf_ids = [i for i, l in enumerate(leaves)
                            if any(n is l for n in sub)]
            worst = max(worst, int(np.isin(exit_idx, sub_leaf_ids).sum()))
        raw = max(floor, margin * worst / B)
        fracs.append(float(min(1.0, np.ceil(raw * grid) / grid)))
    return fracs


def make_routed_infer_fn(net, batch_size, capacities=1.0):
    """Build a routed-inference function for any tree net.

    infer(params, state, x0, k_cpt=None) -> dict with
      probs:    (B, n_cls) fp32 class probabilities from each example's exit
      exit_idx: (B,) int32 preorder index of the leaf the example exited by
      ops:      (B,) fp32 realized op count
      forced:   (n_switches,) int32 per-switch count of examples that chose
                an internal child but overflowed its buffer and were
                force-exited (switches in preorder); all zeros at 1.0.

    x0 is an NHWC batch of exactly `batch_size` images on the device the
    params live on. capacities: a scalar fraction, or a per-switch list in
    preorder; internal children of switch s get buffers of ceil(f_s * B).
    k_cpt: the cost-of-compute price dyn_k_cpt routers condition on; None
    uses the net's own hypers.k_cpt."""
    switches = list(net.switches)
    if np.isscalar(capacities):
        fracs = {id(sw): float(capacities) for sw in switches}
    else:
        if len(capacities) != len(switches):
            raise ValueError("got %d capacities for %d switches"
                             % (len(capacities), len(switches)))
        fracs = {id(sw): float(f) for sw, f in zip(switches, capacities)}
    leaf_index = {id(l): i for i, l in enumerate(net.leaves)}
    switch_pos = {id(sw): i for i, sw in enumerate(switches)}
    n_cls = int(net.hypers.y_shape[0])
    eps_rte = float(_hyper(net, "ϵ", 1e-6))
    B = batch_size

    for sw in switches:
        has_leaf_child = any(len(s.sinks) == 0 for s in sw.sinks)
        if fracs[id(sw)] < 1.0 and not has_leaf_child:
            raise ValueError(
                f"switch {sw.name} has capacity < 1 but no leaf child to "
                "force-exit overflow through")

    @torch.inference_mode()
    def infer(params, state, x0, k_cpt=None):
        if x0.shape[0] != B:
            raise ValueError("batch of %d, built for %d"
                             % (x0.shape[0], B))
        dev = x0.device
        kc = (getattr(net.hypers, "k_cpt", 0.0) if k_cpt is None
              else torch.as_tensor(k_cpt, dtype=torch.float32, device=dev))
        ctx = Ctx(train=False, tau=1.0, eps=eps_rte, k_cpt=kc)
        probs = torch.zeros((B + 1, n_cls), dtype=torch.float32, device=dev)
        exit_idx = torch.full((B + 1,), -1, dtype=torch.int32, device=dev)
        ops = torch.zeros((B + 1,), dtype=torch.float32, device=dev)
        forced = torch.zeros((len(switches),), dtype=torch.int32,
                             device=dev)

        def recurse(node, p, s, act, active_idx, ops_acc, cap):
            # active_idx: original batch row of each buffer slot, B for
            # padding slots.
            act, _, _ = node.apply(p["layer"], s["layer"], act, None, ctx)
            ops_acc = ops_acc + _f32(node.n_ops)

            if len(node.sinks) == 0:
                probs[active_idx] = act.float()
                exit_idx[active_idx] = leaf_index[id(node)]
                ops[active_idx] = ops_acc
                return

            if len(node.sinks) == 1:
                recurse(node.sinks[0], p["sinks"][0], s["sinks"][0], act,
                        active_idx, ops_acc, cap)
                return

            r_x, _, _ = node.router.apply(
                p["router"], s["router"], net._router_input(act, ctx), None,
                ctx)
            ops_acc = ops_acc + _f32(node.router.n_ops)
            valid = active_idx < B
            choice = torch.argmax(r_x, dim=1)
            frac = fracs[id(node)]
            first_leaf = next((i for i, sk in enumerate(node.sinks)
                               if len(sk.sinks) == 0), None)
            slots = torch.arange(cap, device=dev)

            # Internal children first: cap their selections at their
            # buffer size and collect the overflow.
            sels = [(choice == i) & valid for i in range(len(node.sinks))]
            overflow = torch.zeros((cap,), dtype=torch.bool, device=dev)
            plans = []
            for i, sink in enumerate(node.sinks):
                if len(sink.sinks) == 0:
                    continue
                child_cap = max(1, min(cap, math.ceil(frac * B)))
                sel = sels[i]
                order = torch.argsort((~sel).to(torch.uint8), stable=True)
                rank = torch.empty_like(order)
                rank[order] = slots
                kept = sel & (rank < child_cap)
                overflow = overflow | (sel & ~kept)
                plans.append((i, sink, kept, order[:child_cap]))
            forced[switch_pos[id(node)]] += overflow.sum().to(torch.int32)
            # Leaf children: their own selections, plus (for the first
            # leaf) everything that overflowed an internal child.
            for i, sink in enumerate(node.sinks):
                if len(sink.sinks) != 0:
                    continue
                sel = sels[i] | overflow if i == first_leaf else sels[i]
                order = torch.argsort((~sel).to(torch.uint8), stable=True)
                plans.append((i, sink, sel, order[:cap]))

            for i, sink, kept, perm in plans:
                child_idx = torch.where(kept[perm], active_idx[perm], B)
                recurse(sink, p["sinks"][i], s["sinks"][i],
                        _gather_act(act, perm), child_idx, ops_acc[perm],
                        len(perm))

        recurse(net.root, params, state, x0,
                torch.arange(B, dtype=torch.int64, device=dev),
                torch.zeros((B,), dtype=torch.float32, device=dev), B)
        del recurse  # break the closure's cycle (see Net.forward)
        return {"probs": probs[:B], "exit_idx": exit_idx[:B],
                "ops": ops[:B], "forced": forced}

    return infer
