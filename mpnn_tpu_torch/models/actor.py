"""Actor networks (counterpart of `mpnn_tpu/models/actor.py`): the class and
its hypers. The actor loss comes with the training slice."""

from .net import Net
from .routed import DynRoutedMixin


class ActorNet(DynRoutedMixin, Net):
    default_hypers = dict(
        Net.default_hypers,
        k_cpt=0.0, k_dec=0.01, ϵ=1e-6, τ=1.0, λ_lrn=1e-3, μ_lrn=0.9,
        dyn_k_cpt=False, α_cpt=1e7, talr=True, α_rtr=1.0,
        globopt=False, k_pol=0.01)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if self.hypers.globopt and self.hypers.talr:
            raise ValueError(
                "globopt requires talr=False: without the eps-mixture floor "
                "TALR's 1/sqrt(E[p_tr^2]) scale is unbounded")
