"""Architectures, training constants, net constructors and the experiment
registries (counterpart of `mpnn_tpu/experiments.py`): the reference's
constants, schedules and component builders, the chain and tree
constructors, the train-nets registry and the train-adaptive-nets
registry, entry for entry."""

from types import SimpleNamespace as Ns

from .models import ActorNet, CriticNet, SRNet
from .ops.layers import (
    BatchNorm, Chain, CrossEntropyError, LinTrans, MultiscaleBatchNorm,
    MultiscaleConvMax, MultiscaleRect, Rect, Select, Softmax, ToPyramid)

conv_supp = 3
router_n_chan = 16

k_cpts = [0.0, 1e-9, 2e-9, 4e-9, 8e-9, 1.6e-8, 3.2e-8, 6.4e-8]
k_l2 = 1e-4
σ_w = 1

# 8-stage channel plan: 4-scale 16-chan blocks narrowing to 1-scale 128-chan.
arch = [
    [16, 16, 16, 16],
    [16, 16, 16, 16],
    [32, 32, 32],
    [32, 32, 32],
    [64, 64],
    [64, 64],
    [128],
    [128]]

# Training hyperparameters (`mpnn_tpu/experiments.py:47-53`); the actor
# chains train with τ_ds, the critic chains with τ_cr.
n_iter = 80000
t_log = 2500
batch_size = 128

λ_lrn = lambda t: 0.1 / 2 ** (t / 10000)  # noqa: E731
τ_cr = lambda t: 0.1 / 2 ** (t / 20000)  # noqa: E731
τ_ds = lambda t: 1 / 2 ** (t / 20000)  # noqa: E731


def router(n_sinks):
    """Routing head: coarsest scale -> 2x [dense16 + BN + ReLU] -> dense
    (zero-init final layer). None for non-switch nodes."""
    if n_sinks < 2:
        return None
    return Chain(name="Router", comps=[
        Select(i=-1),
        LinTrans(n_chan=router_n_chan, k_l2=k_l2, σ_w=σ_w),
        BatchNorm(), Rect(),
        LinTrans(n_chan=router_n_chan, k_l2=k_l2, σ_w=σ_w),
        BatchNorm(), Rect(),
        LinTrans(n_chan=n_sinks, k_l2=k_l2, σ_w=0)])


def pyr(*sinks):
    return Chain(
        name="ToPyramid", sinks=sinks, router=router(len(sinks)),
        comps=[ToPyramid(n_scales=len(arch[0]))])


def rcm(i, *sinks, width=1):
    """Conv stage i; `width` scales every channel count."""
    return Chain(
        name="ReConvMax", sinks=sinks, router=router(len(sinks)),
        comps=[
            MultiscaleConvMax(n_chan=[width * c for c in arch[i]],
                              supp=conv_supp, k_l2=k_l2, σ_w=σ_w),
            MultiscaleBatchNorm(), MultiscaleRect()])


def reg(n_chan):
    """Early-exit logistic-regression leaf."""
    return Chain(name="LogReg", comps=[
        Select(i=-1),
        LinTrans(n_chan=n_chan, k_l2=k_l2, σ_w=σ_w),
        Softmax(), CrossEntropyError()])


def sr_chain(n_tf, width=1):
    """Statically routed chain of the first n_tf conv stages."""
    def make_net(x0_shape, y_shape):
        root = reg(y_shape[0])
        for i in reversed(range(n_tf)):
            root = rcm(i, root, width=width)
        root = pyr(root)
        return SRNet(x0_shape=x0_shape, y_shape=y_shape, root=root)
    return make_net


def dr_chain(type_, width=1, **hypers):
    """Dynamically-routed 8-deep chain; every node also feeds an early-exit
    LogReg leaf."""
    def make_net(x0_shape, y_shape):
        root = rcm(len(arch) - 1, reg(y_shape[0]), width=width)
        for i in reversed(range(len(arch) - 1)):
            root = rcm(i, reg(y_shape[0]), root, width=width)
        root = pyr(root)
        return type_(x0_shape=x0_shape, y_shape=y_shape, root=root, **hypers)
    return make_net


def dr_tree(type_, **hypers):
    """Dynamically-routed branching tree: 2-way fans at depths 0-2 (each
    fan node also feeds an early-exit LogReg leaf, so its router is
    3-way), then eight 5-deep chain tails of the same shape."""
    def make_net(x0_shape, y_shape):
        def tail():
            node = rcm(len(arch) - 1, reg(y_shape[0]))
            for i in reversed(range(3, len(arch) - 1)):
                node = rcm(i, reg(y_shape[0]), node)
            return node

        def fan(i):
            if i < 3:
                return rcm(i, reg(y_shape[0]), fan(i + 1), fan(i + 1))
            return tail()

        root = pyr(fan(0))
        return type_(x0_shape=x0_shape, y_shape=y_shape, root=root, **hypers)
    return make_net


def ac_chain(**hypers):
    return dr_chain(ActorNet, **hypers)


def ac_tree(**hypers):
    return dr_tree(ActorNet, **hypers)


def cr_chain(**hypers):
    return dr_chain(CriticNet, **hypers)


def cr_tree(**hypers):
    return dr_tree(CriticNet, **hypers)


################################################################################
# Experiment registries
################################################################################

# Per-net-type tau schedule (None: the net's own τ).
SR_TAU, AC_TAU, CR_TAU = None, τ_ds, τ_cr

def _sweep_sr(dataset, width=1):
    return Ns(dataset=dataset,
              nets=[sr_chain(n, width=width)
                    for n in range(1, len(arch) + 1)],
              tau=SR_TAU)


def _sweep(dataset, ctor, tau, **hypers):
    """A k_cpt sweep: 8 same-architecture nets differing only in the
    cost-of-compute price."""
    return Ns(dataset=dataset,
              nets=[ctor(k_cpt=k, **hypers) for k in k_cpts],
              tau=tau, sweep_k_cpts=list(k_cpts))


def make_experiments():
    """`mpnn_tpu`'s train-nets registry, by name."""
    return {
        "hybrid-sr": _sweep_sr("data/hybrid.npz"),
        "hybrid-ac": _sweep("data/hybrid.npz", ac_chain, AC_TAU),
        "hybrid-ac-nokdec": _sweep("data/hybrid.npz", ac_chain, AC_TAU,
                                   k_dec=0),
        "hybrid-ac-notalr": _sweep("data/hybrid.npz", ac_chain, AC_TAU,
                                   talr=False),
        "hybrid-ac-tree": _sweep("data/hybrid.npz", ac_tree, AC_TAU),
        "hybrid-ac-globopt": _sweep("data/hybrid.npz", ac_chain, AC_TAU,
                                    globopt=True, talr=False),
        "hybrid-cr": _sweep("data/hybrid.npz", cr_chain, CR_TAU),
        "hybrid-cr-opt": _sweep("data/hybrid.npz", cr_chain, CR_TAU,
                                optimistic=True),
        "hybrid-cr-clserr": _sweep("data/hybrid.npz", cr_chain, CR_TAU,
                                   use_cls_err=True),
        "hybrid-cr-notalr": _sweep("data/hybrid.npz", cr_chain, CR_TAU,
                                   talr=False),
        "cifar2-sr": _sweep_sr("data/cifar-2.npz"),
        "cifar2-ac": _sweep("data/cifar-2.npz", ac_chain, AC_TAU),
        "cifar5-sr": _sweep_sr("data/cifar-5.npz"),
        "cifar5-ac": _sweep("data/cifar-5.npz", ac_chain, AC_TAU),
        "cifar10-sr": _sweep_sr("data/cifar-10.npz"),
        "cifar10-ac": _sweep("data/cifar-10.npz", ac_chain, AC_TAU),
        "cifar10-sr-fat": _sweep_sr("data/cifar-10.npz", width=2),
        "cifar10-ac-fat": _sweep("data/cifar-10.npz", ac_chain, AC_TAU,
                                 width=2),
        "cifar10-sr-fatter": _sweep_sr("data/cifar-10.npz", width=4),
        "cifar10-ac-fatter": _sweep("data/cifar-10.npz", ac_chain, AC_TAU,
                                    width=4),
        "mnist-sr": _sweep_sr("data/mnist.npz"),
        "cifar10-cr": _sweep("data/cifar-10.npz", cr_chain, CR_TAU),
        "synth-sr": _sweep_sr("data/synth.npz"),
        "synth-ac": _sweep("data/synth.npz", ac_chain, AC_TAU),
        "synth-ac-globopt": _sweep("data/synth.npz", ac_chain, AC_TAU,
                                   globopt=True, talr=False),
        "synth-cr": _sweep("data/synth.npz", cr_chain, CR_TAU),
        "synth-ac-tree": _sweep("data/synth.npz", ac_tree, AC_TAU),
        "synth-cr-tree": _sweep("data/synth.npz", cr_tree, CR_TAU),
    }


def make_adaptive_experiments():
    """`mpnn_tpu`'s train-adaptive-nets registry, by name: single nets
    whose routers condition on the price (dyn_k_cpt), trained with k_cpt
    sampled per example from `k_cpts` each batch."""
    return {
        "hybrid-ac-dynkcpt": Ns(
            dataset="data/hybrid.npz", net=ac_chain(dyn_k_cpt=True),
            tau=AC_TAU),
        "hybrid-ac-tree-dynkcpt": Ns(
            dataset="data/hybrid.npz", net=ac_tree(dyn_k_cpt=True),
            tau=AC_TAU),
        "hybrid-cr-dynkcpt": Ns(
            dataset="data/hybrid.npz", net=cr_chain(dyn_k_cpt=True),
            tau=CR_TAU),
        "hybrid-cr-tree-dynkcpt": Ns(
            dataset="data/hybrid.npz", net=cr_tree(dyn_k_cpt=True),
            tau=CR_TAU),
        "synth-ac-dynkcpt": Ns(
            dataset="data/synth.npz", net=ac_chain(dyn_k_cpt=True),
            tau=AC_TAU),
        "synth-ac-tree-dynkcpt": Ns(
            dataset="data/synth.npz", net=ac_tree(dyn_k_cpt=True),
            tau=AC_TAU),
        "synth-cr-dynkcpt": Ns(
            dataset="data/synth.npz", net=cr_chain(dyn_k_cpt=True),
            tau=CR_TAU),
        # Price-insensitivity probes of the adaptive critic: a larger
        # price feature (α_cpt) and the actor's hotter τ schedule.
        "synth-cr-dynkcpt-acpt1e9": Ns(
            dataset="data/synth.npz",
            net=cr_chain(dyn_k_cpt=True, α_cpt=1e9), tau=CR_TAU),
        "synth-cr-dynkcpt-tauhot": Ns(
            dataset="data/synth.npz", net=cr_chain(dyn_k_cpt=True),
            tau=AC_TAU),
        "hybrid-cr-dynkcpt-acpt1e9": Ns(
            dataset="data/hybrid.npz",
            net=cr_chain(dyn_k_cpt=True, α_cpt=1e9), tau=CR_TAU),
    }
