"""Compute-precision policy of the layer zoo (counterpart of
`mpnn_tpu/ops/config.py`).

Parameters are stored float32. When `compute_dtype` is `torch.bfloat16`,
convs and matmuls cast their inputs and weights to bf16 and emit bf16
outputs (products accumulate in fp32 inside the kernel or library call);
softmax and loss terms run in fp32. None means float32 throughout.

There is no kernel on/off switch: on a CUDA tensor the MultiscaleConvMax
stage is the hand-written kernel (`ops/kernels.py`)."""

import torch

compute_dtype = None  # None => float32 everywhere

# Analytic L2: when True, LinTrans and MultiscaleConvMax leave their
# c_mod = k_l2 * sum((w - w_eq)^2) out of the forward; the train step adds
# the same gradient 2 * k_l2 * (w - w_eq), weighted by the node's mean p_tr
# as the sg(p_tr)-weighted loss term would be, and the loss value with one
# reduction per weight (models/optim.py:tree_l2_decay). Gradients and loss
# are equal either way.
analytic_l2 = False


def set_analytic_l2(flag):
    global analytic_l2
    analytic_l2 = bool(flag)


def set_compute_dtype(dtype):
    """Set the global compute dtype (None, torch.float32 or torch.bfloat16)."""
    global compute_dtype
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError("compute dtype must be None, float32 or bfloat16, "
                         "got %r" % (dtype,))
    compute_dtype = None if dtype is torch.float32 else dtype


def cast_compute(t):
    """Cast a tensor to the compute dtype (no-op if unset)."""
    return t if compute_dtype is None else t.to(compute_dtype)


# Congruent-subtree stacking inside `Net.forward`: each group of
# structurally identical subtrees of the build-time stack plan (dr_tree's
# eight 5-stage tails, dr_chain's congruent LogReg leaves) runs as one
# `torch.func.vmap` of a template over stacked params, state and inputs,
# so the tails' stages are one launch of `fused_mcm`'s net axis each.
# Same math, vmapped. Off by default, as in `mpnn_tpu`.
stacked_tails = False


def set_stacked_tails(flag):
    global stacked_tails
    stacked_tails = bool(flag)


# Activation rematerialization in the train step's backward
# (`models/steps.py:_remat`): None stores every activation; "full"
# recomputes the loss function's whole forward in the backward
# (`torch.utils.checkpoint`); "dots" saves the outputs of convs, matmuls
# and `fused_mcm` and recomputes the rest (selective checkpointing), as
# JAX's `dots_saveable` does. Off by default, as in `mpnn_tpu`.
remat_policy = None


def set_remat(policy):
    global remat_policy
    if policy not in (None, "full", "dots"):
        raise ValueError("remat policy must be None, 'full' or 'dots', "
                         "got %r" % (policy,))
    remat_policy = policy


# TF1 parity of the pyramid: `ToPyramid` takes TF1's legacy bilinear grid
# (src = dst * in/out, no half-pixel shift, clamped; a strided slice at
# the x2 ratios of every experiment) instead of the antialiased
# half-pixel grid. Parameters trained by the reference evaluate correctly
# only under this grid. Off by default, as in `mpnn_tpu`.
pyramid_tf1 = False


def set_pyramid_tf1(flag):
    global pyramid_tf1
    pyramid_tf1 = bool(flag)


# TF1 parity of `MaxPool`: the reference passes its `stride` hyper as the
# window and `supp` as the stride, so what it computes is window=stride,
# stride=supp. Off (window=supp, stride=stride) by default, as in
# `mpnn_tpu`; for records trained by the reference that hold a MaxPool.
maxpool_tf1 = False


def set_maxpool_tf1(flag):
    global maxpool_tf1
    maxpool_tf1 = bool(flag)


# NaN trap of the train steps (`models/steps.py:check_nans`, the
# counterpart of `jax_debug_nans` under `train --debug-nans`): after each
# step, one check over the loss, the gradients and the updated params,
# state and velocity, one host read, and FloatingPointError naming the
# step and the first NaN leaf. Inf passes, as under jax_debug_nans. Off by
# default.
debug_nans = False


def set_debug_nans(flag):
    global debug_nans
    debug_nans = bool(flag)
