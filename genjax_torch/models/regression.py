"""Regression model families (counterpart of
``genjax_tpu/models/regression.py``)."""

from __future__ import annotations

import torch

from genjax_torch.lang.distributions import mv_normal_diag, normal
from genjax_torch.lang.static import gen

__all__ = ["hierarchical_regression"]


def hierarchical_regression():
    """Bayesian linear regression with a learned noise scale, on the
    unconstrained ``log_sigma`` (NUTS-ready): addresses ``"slope"``,
    ``"icept"``, ``"log_sigma"``, ``"ys"``. Under a key batch the scalars
    have the batch's shape, so each gains the points' axis behind it."""

    @gen
    def regression(xs):
        slope = normal(0.0, 2.0) @ "slope"
        icept = normal(0.0, 2.0) @ "icept"
        log_sigma = normal(-1.0, 0.7) @ "log_sigma"
        sigma = torch.exp(log_sigma)
        _ = mv_normal_diag(slope[..., None] * xs + icept[..., None],
                           sigma[..., None] * torch.ones_like(xs)) @ "ys"

    return regression
