"""Model families with exact oracles (counterpart of
``genjax_tpu/models``)."""

from genjax_torch.models.ssm import (
    kalman_filter,
    kalman_smoother,
    lgssm_grid_posterior,
    lgssm_model,
    nonlinear_tracking_model,
    simulate_lgssm_data,
)
from genjax_torch.models.regression import hierarchical_regression
from genjax_torch.models.mixture import gaussian_mixture
from genjax_torch.models.hmm import hmm_bootstrap_filter, hmm_model
from genjax_torch.models.slds import (
    SLDSParams,
    simulate_slds_data,
    slds_exact_log_marginal,
    slds_rbpf,
)

__all__ = [
    "SLDSParams",
    "gaussian_mixture",
    "hierarchical_regression",
    "hmm_bootstrap_filter",
    "hmm_model",
    "kalman_filter",
    "kalman_smoother",
    "lgssm_grid_posterior",
    "simulate_lgssm_data",
    "lgssm_model",
    "nonlinear_tracking_model",
    "simulate_slds_data",
    "slds_exact_log_marginal",
    "slds_rbpf",
]
