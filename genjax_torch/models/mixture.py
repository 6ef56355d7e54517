"""Mixture model families (counterpart of
``genjax_tpu/models/mixture.py``)."""

from __future__ import annotations

import torch

from genjax_torch.lang.distributions import categorical, normal
from genjax_torch.lang.static import gen

__all__ = ["gaussian_mixture"]


def gaussian_mixture(n_components: int):
    """A K-component 1-D Gaussian mixture with a categorical assignment
    per draw, at ``"comp"`` and ``"x"``; arguments ``(logits, locs,
    scales)``. Under a key batch the component selects each execution's
    own location and scale (a gather behind the batch)."""

    @gen
    def mixture(logits, locs, scales):
        comp = categorical(logits) @ "comp"
        pick = comp[..., None]
        loc = torch.take_along_dim(torch.as_tensor(locs), pick, dim=-1)
        scale = torch.take_along_dim(torch.as_tensor(scales), pick, dim=-1)
        return normal(loc[..., 0], scale[..., 0]) @ "x"

    return mixture
