"""Architectures, training constants and net constructors of the flagship
(counterpart of `mpnn_tpu/experiments.py:23-150`): the reference's
constants, schedules and component builders, so a fresh flagship can be
built and trained."""

from .models import ActorNet
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
