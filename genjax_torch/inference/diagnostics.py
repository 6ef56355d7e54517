"""MCMC diagnostics: split R-hat, autocorrelation effective sample size,
and a summary (counterpart of ``genjax_tpu/inference/diagnostics.py``).

Every function takes ``samples`` of shape ``(chains, draws, ...)`` and
reduces over the first two axes. One deliberate difference from the JAX
package: the effective sample size is capped at ``c·n·log10(c·n)``, as
Stan caps it, where the JAX package lets a near-zero autocorrelation
time give an ESS of up to ``(c·n)²``. Where the cap does not bind, the
two agree.
"""

from __future__ import annotations

import math

import torch

__all__ = ["split_rhat", "ess_autocorr", "summarize"]

#: Lags whose autocovariances are formed at once: the loop over lags
#: holds ``_LAG_CHUNK · chains · draws`` values, never all of them.
_LAG_CHUNK = 64


def split_rhat(samples: torch.Tensor) -> torch.Tensor:
    """Split-chain potential scale reduction (Gelman et al.) of
    ``samples`` (chains, draws, ...); values near 1 indicate
    convergence."""
    n = samples.shape[1]
    half = n // 2
    split = torch.cat([samples[:, :half], samples[:, half:2 * half]], dim=0)
    n2 = split.shape[1]
    chain_means = split.mean(dim=1)
    chain_vars = split.var(dim=1, correction=1)
    between = n2 * chain_means.var(dim=0, correction=1)
    within = chain_vars.mean(dim=0)
    var_plus = (n2 - 1) / n2 * within + between / n2
    return torch.sqrt(var_plus / within)


def ess_autocorr(samples: torch.Tensor, max_lag: int | None = None
                 ) -> torch.Tensor:
    """Effective sample size by Geyer's initial monotone sequence (the
    Stan scheme) over (chains, draws, ...): autocorrelations summed in
    pairs ``Γ_k = ρ_2k + ρ_2k+1``, truncated at the first nonpositive
    pair and forced nonincreasing; ``τ = −1 + 2·ΣΓ_k`` and ``ESS =
    c·n/τ``, capped at ``c·n·log10(c·n)``."""
    c, n = samples.shape[0], samples.shape[1]
    cn = float(c * n)
    if max_lag is None:
        max_lag = min(n - 2, 1000)
    max_lag = max_lag if max_lag % 2 == 1 else max_lag - 1  # full pairs
    if max_lag < 1:
        # Too few draws for any autocorrelation: treat them as
        # independent.
        return torch.full(samples.shape[2:], cn, dtype=samples.dtype,
                          device=samples.device)
    centered = samples - samples.mean(dim=1, keepdim=True)
    var = samples.var(dim=1, correction=1).mean(dim=0)
    steps = torch.arange(n, device=samples.device)
    extra = (1,) * (samples.ndim - 2)
    rhos = []
    for start in range(1, max_lag + 1, _LAG_CHUNK):
        lags = torch.arange(start, min(start + _LAG_CHUNK, max_lag + 1),
                            device=samples.device)
        # Draw t + lag for every lag of the chunk, masked past the end
        # (the JAX package's roll + mask).
        idx = steps[None, :] + lags[:, None]                  # (L, n)
        valid = (idx < n).to(samples.dtype)
        shifted = centered[:, idx.clamp(max=n - 1)]         # (c, L, n, ...)
        prod = centered[:, None] * shifted * valid.reshape(
            (1,) + tuple(valid.shape) + extra)
        denom = (c * torch.clamp(n - lags, min=1)).to(samples.dtype)
        rhos.append(prod.sum(dim=(0, 2)) / denom.reshape((-1,) + extra)
                    / torch.clamp(var, min=1e-12))
    rho = torch.cat([torch.ones((1,) + tuple(var.shape), dtype=var.dtype,
                                device=var.device)] + rhos, dim=0)
    gam = rho[0::2] + rho[1::2]                               # pairs
    k_pairs = gam.shape[0]
    nonpos = gam <= 0.0
    cutoff = torch.where(nonpos.any(dim=0),
                         torch.argmax(nonpos.to(torch.int8), dim=0),
                         torch.full_like(nonpos[0], k_pairs,
                                         dtype=torch.int64))
    pair = torch.arange(k_pairs, device=gam.device).reshape(
        (k_pairs,) + (1,) * (gam.ndim - 1))
    keep = pair < cutoff[None]
    gam = torch.cummin(gam, dim=0).values
    tau = -1.0 + 2.0 * torch.where(keep, gam, torch.zeros_like(gam)).sum(0)
    floor = 1.0 / math.log10(cn) if cn > 1.0 else 1.0
    return cn / torch.clamp(tau, min=floor)


def summarize(samples: torch.Tensor) -> dict:
    """Mean, standard deviation, split R-hat and ESS of (chains, draws,
    ...) samples."""
    return {
        "mean": samples.mean(dim=(0, 1)),
        "std": samples.std(dim=(0, 1), correction=0),
        "rhat": split_rhat(samples),
        "ess": ess_autocorr(samples),
    }
