"""Architectures, training constants, net constructors and the experiment
registry (counterpart of `mpnn_tpu/experiments.py`): the reference's
constants, schedules and component builders, and every registry entry
whose nets are chains. The three `*-tree` entries wait for the port of
`dr_tree` (`TREE_EXPERIMENTS`); the adaptive registry is not ported."""

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


def ac_chain(**hypers):
    return dr_chain(ActorNet, **hypers)


def cr_chain(**hypers):
    return dr_chain(CriticNet, **hypers)


################################################################################
# Experiment registry
################################################################################

# Per-net-type tau schedule (None: the net's own τ).
SR_TAU, AC_TAU, CR_TAU = None, τ_ds, τ_cr

# Registry entries of `mpnn_tpu` whose nets are trees (dr_tree): not ported.
TREE_EXPERIMENTS = ("hybrid-ac-tree", "synth-ac-tree", "synth-cr-tree")


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
    """The chain entries of `mpnn_tpu`'s train-nets registry, by name."""
    return {
        "hybrid-sr": _sweep_sr("data/hybrid.npz"),
        "hybrid-ac": _sweep("data/hybrid.npz", ac_chain, AC_TAU),
        "hybrid-ac-nokdec": _sweep("data/hybrid.npz", ac_chain, AC_TAU,
                                   k_dec=0),
        "hybrid-ac-notalr": _sweep("data/hybrid.npz", ac_chain, AC_TAU,
                                   talr=False),
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
    }
