from .net import Net, Ctx, Rec, n_leaves
from .actor import ActorNet
from .infer import make_routed_infer_fn, calibrate_capacities, chain_stages
from .routing import propagate, switch_probs
from .optim import talr_scale_grads, momentum_init, momentum_update
from .steps import Schedules, make_train_step, init_training
from .stats import state_stats, tot_n_ops

__all__ = ["Net", "Ctx", "Rec", "n_leaves", "ActorNet",
           "make_routed_infer_fn", "calibrate_capacities", "chain_stages",
           "propagate", "switch_probs", "talr_scale_grads", "momentum_init",
           "momentum_update", "Schedules", "make_train_step",
           "init_training", "state_stats", "tot_n_ops"]
