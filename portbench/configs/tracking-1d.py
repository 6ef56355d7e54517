"""Plain reference of ``tracking-1d``: the univariate nonstationary growth
model of Gordon, Salmond and Smith (1993) without its cosine forcing,

    x0 ~ N(0, 1),  x' = a x + b x / (1 + x²) + sd ε,  y ~ N(x² / 20, 1),

on bench config 4's observations ``scale · normal(key(obs_key), (T,))``
(:func:`inputs`, made once by the benchmark and handed to the port and
to the reference alike), for the benchmark's filter reference
(``reference/filters.py``). Every value is computed in the dtype asked
for (float64 for the judge, a lower one for the control) from the keys'
float32 uniforms.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import threefry


def inputs(cfg: dict, mix: dict, device) -> dict:
    """The observations, float32 ``(T,)``, the same in every run."""
    obs_key = threefry.seed_key(cfg["obs_key"], device)
    obs = cfg["obs_scale"] * threefry.normal(obs_key, (cfg["steps"],))
    return {"observations": obs.to(torch.float32)}


class Model:
    """The filter's model in one of two noise streams: ``counter`` draws
    the fused step's counter normals (Box-Muller), ``keyed`` each step's
    ``normal(key, (n,))``."""

    discrete = False

    def __init__(self, cfg: dict, obs: torch.Tensor, noise: str, device):
        if noise not in ("counter", "keyed"):
            raise ValueError(f"tracking-1d: no noise stream {noise!r}")
        self.cfg, self.fused, self.device = cfg, noise == "counter", device
        self.obs = obs.to(device)
        #: Propagation steps a call: one an observation.
        self.steps = obs.shape[0]

    def init(self, key, n: int, dtype):
        return (threefry.normal(key, (n,)).to(dtype),
                torch.zeros(n, dtype=dtype, device=self.device))

    def step(self, key, t: int, xs, dtype):
        cfg = self.cfg
        n = xs.shape[0]
        eps = (threefry.counter_normal(key, n) if self.fused
               else threefry.normal(key, (n,))).to(dtype)
        x = (cfg["a"] * xs + cfg["b"] * xs / (1.0 + xs * xs)
             + math.sqrt(cfg["process_variance"]) * eps).to(dtype)
        y = self.obs[t].to(dtype)
        d = y - x * x / cfg["obs_divisor"]
        var = cfg["obs_variance"]
        ll = -0.5 * d * d / var - 0.5 * math.log(2 * math.pi * var)
        return x, ll.to(dtype)


def filter_model(cfg: dict, inputs: dict, noise: str, device):
    return Model(cfg, inputs["observations"], noise, device)
