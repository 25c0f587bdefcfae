"""Checkpoint -> serving artifact (counterpart of `mpnn_tpu/export.py`),
through `torch.export`.

`export_infer` traces the routed sparse inference function
(`models/infer.py:make_routed_infer_fn`) into a `torch.export`
`ExportedProgram`:

- the trained params and BatchNorm statistics are baked into the program
  as constants: serving needs no `Net`, no checkpoint and no layer zoo;
- the compute dtype, the TF1 modes (`ops.config.pyramid_tf1`,
  `maxpool_tf1`) and the capacities are fixed when it is traced: each
  MultiscaleConvMax stage is one node of the operator
  `mpnn_tpu_torch::mcm_stage` (`ops/kernels.py`), which carries its
  compute dtype as an argument, and every other cast is a node of its own;
- for dyn_k_cpt (adaptive) checkpoints the cost-of-compute price stays a
  0-d fp32 input, so one artifact serves every operating point;
- `load_artifact(path, device)` moves the program to another device
  (`torch.export.passes.move_to_device_pass`), the counterpart of JAX's
  `platforms`: one file serves on the card and on a CPU canary. The
  operator dispatches by device: the CUDA kernel on CUDA tensors, its
  plain version `mcm_ref` on CPU tensors.

A deliberate difference from JAX's artifact, which needs `jax` alone: a
torch artifact needs `torch` and the registration of `mcm_stage`, so
`load_artifact` imports `mpnn_tpu_torch.ops.kernels` (which imports only
torch and the ops package). It needs nothing else of this package.

CLI: `python -m mpnn_tpu_torch.export_net`."""

import torch

__all__ = ["export_infer", "save_artifact", "load_artifact", "serve_fn"]


class _Serve(torch.nn.Module):
    """infer(params, state, x0[, k_cpt]) with params and state held."""

    def __init__(self, infer, params, state):
        super().__init__()
        self.infer, self.params, self.state = infer, params, state

    def forward(self, x0, *k_cpt):
        return self.infer(self.params, self.state, x0, *k_cpt)


def export_infer(net, params, state, *, batch_size, capacities=1.0,
                 dyn_k_cpt=False):
    """Trace the routed-inference function of `net` with `params` / `state`
    baked in as constants; returns a `torch.export.ExportedProgram`.

    The program takes (x0,), or (x0, k_cpt) with a 0-d fp32 k_cpt when
    dyn_k_cpt, with x0: (batch_size, *x0_shape) fp32 on the device the
    params live on, and returns the infer dict {probs, exit_idx, ops,
    forced} (`models/infer.py:make_routed_infer_fn`)."""
    from .models.infer import make_routed_infer_fn
    from .utils.tree import tree_leaves
    dev = tree_leaves(params)[0].device
    infer = make_routed_infer_fn(net, batch_size, capacities)
    args = (torch.zeros((batch_size, *net.hypers.x0_shape),
                        dtype=torch.float32, device=dev),)
    if dyn_k_cpt:
        args += (torch.zeros((), dtype=torch.float32, device=dev),)
    exported = torch.export.export(_Serve(infer, params, state), args,
                                   strict=False)
    # The example batch would be saved with the program: 12.6 MB of
    # zeros at batch 1024, three times the flagship's params.
    exported.example_inputs = None
    return exported


def save_artifact(exported, path):
    """Write an ExportedProgram to `path` (`torch.export.save`)."""
    torch.export.save(exported, path)


def load_artifact(path, device=None):
    """The ExportedProgram of an artifact, moved to `device` when one is
    given (e.g. "cpu" for a canary of an artifact traced on the card)."""
    from .ops import kernels  # noqa: F401  registers mcm_stage
    exported = torch.export.load(path)
    if device is not None:
        from torch.export.passes import move_to_device_pass
        exported = move_to_device_pass(exported, torch.device(device))
    return exported


def serve_fn(path, device=None):
    """A callable of an artifact: fn(x0), or fn(x0, k_cpt) for adaptive
    artifacts -> the infer dict. It runs the program under
    `torch.inference_mode`, as the engine it was traced from runs."""
    module = load_artifact(path, device).module()

    @torch.inference_mode()
    def serve(*args):
        return module(*args)

    return serve
