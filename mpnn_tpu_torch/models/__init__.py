from .net import Net, Ctx, Rec, n_leaves
from .actor import ActorNet
from .critic import CriticNet
from .sr import SRNet
from .infer import make_routed_infer_fn, calibrate_capacities, chain_stages
from .routing import propagate, switch_probs
from .optim import talr_scale_grads, momentum_init, momentum_update
from .steps import (Schedules, make_train_step, make_train_loop,
                    make_eval_split_fn, init_training)
from .stats import state_stats, tot_n_ops

__all__ = ["Net", "Ctx", "Rec", "n_leaves", "ActorNet", "CriticNet", "SRNet",
           "make_routed_infer_fn", "calibrate_capacities", "chain_stages",
           "propagate", "switch_probs", "talr_scale_grads", "momentum_init",
           "momentum_update", "Schedules", "make_train_step",
           "make_train_loop", "make_eval_split_fn", "init_training",
           "state_stats", "tot_n_ops"]
