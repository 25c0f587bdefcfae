from .net import Net, Ctx, n_leaves
from .actor import ActorNet
from .infer import make_routed_infer_fn, calibrate_capacities, chain_stages

__all__ = ["Net", "Ctx", "n_leaves", "ActorNet", "make_routed_infer_fn",
           "calibrate_capacities", "chain_stages"]
