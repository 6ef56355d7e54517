"""Driver ``batched_pf``: the port's general filter,
``inference.pf.particle_filter(init, step, n, batched=True)``, on the
configuration's model as ``genjax_torch/entry.py``'s ``build_pf`` builds
it (one key a step for the whole ensemble: ``init`` draws
``normal(key, (n,))`` in the state's dtype, ``step`` propagates with
``normal(key, (n,))`` and weighs in float32), the model's torch form
named by the configuration's ``port`` block. The resampling goes
through the filter's documented ``resample_fn`` hook, which does what
its default does and keeps what the judge reads.
"""

from __future__ import annotations

import importlib

import torch

from portbench.lib import plugins
from portbench.lib.filter_driver import HookedFilterDriver


class Driver(HookedFilterDriver):
    noise = "keyed"

    def setup(self):
        pf = importlib.import_module("genjax_torch.inference.pf")
        from genjax_torch.core import random

        port = self.cfg["port"]
        propagate = plugins.port_object(port["propagate"])
        loglik = plugins.port_object(port["loglik"])
        n, sd = self.n, self.state_dtype

        def init(key):
            return (random.normal(key, (n,)).to(sd),
                    torch.zeros(n, device=key.device))

        def step(key, xs, y):
            x = propagate(xs.to(torch.float32), random.normal(key, (n,)))
            return x.to(sd), loglik(x, y)

        self.pf = pf.particle_filter(init, step, n,
                                     ess_threshold=self.threshold,
                                     batched=True,
                                     resample_fn=self.resample_hook())
