"""Driver ``fused_pf``: the port's fused filter,
``inference.pf.fused_particle_filter``, on the configuration's model as
``genjax_torch/entry.py``'s ``build_pf_fused`` builds it (``init`` draws
``normal(key, (n,))``; each step one launch of the fused step with the
model's CUDA form), the model named by the configuration's ``port``
block.

The fused filter has no hook between its steps. What the judge reads
comes from the boundary that defines this path, the fused step itself
(``ops.fused_step.fused_step``, a public op, as the filter reads it from
its module at each step): the ensemble and weights each step takes and
gives. After the call, a step whose weights came in as zeros where the
last step's went out is a resampling: the last step's output is what
was resampled and this step's input is the result.
"""

from __future__ import annotations

import importlib

import torch

from portbench.lib import plugins
from portbench.lib.filter_driver import FilterDriver, _host
from portbench.reference import filters


class Driver(FilterDriver):
    noise = "counter"

    def setup(self):
        pf = importlib.import_module("genjax_torch.inference.pf")
        from genjax_torch.core import random

        port = self.cfg["port"]
        n = self.n

        def recording(fused_step):
            def fused_step_kept(key, xs, lw, *args, **kwargs):
                out = fused_step(key, xs, lw, *args, **kwargs)
                if self._kept is not None:
                    self._kept.append((xs, lw, out[0], out[1]))
                return out
            return fused_step_kept

        self.wrap("genjax_torch.inference.pf", "fused_step", recording)
        self.pf = pf.fused_particle_filter(
            lambda k: random.normal(k, (n,)),
            plugins.port_object(port["propagate"]),
            plugins.port_object(port["loglik"]), n,
            ess_threshold=self.threshold, state_dtype=self.state_dtype,
            cuda_model=plugins.port_object(port["cuda_model"]))

    def keep(self, out) -> filters.Record:
        rec = filters.Record()
        steps = self._kept or []
        if len(steps) != self.steps:
            rec.broken = f"{len(steps)} fused steps, not {self.steps}"
            return self._final(out, rec)
        for t in range(1, len(steps)):
            xs_in, lw_in = steps[t][0], steps[t][1]
            xs_prev, lw_prev = steps[t - 1][2], steps[t - 1][3]
            if lw_in is lw_prev or torch.equal(lw_in, lw_prev):
                if not (xs_in is xs_prev or torch.equal(xs_in, xs_prev)):
                    rec.broken = f"step {t} took other states unweighted"
                continue
            if bool((lw_in != 0).any()):
                rec.broken = f"step {t} took weights of no step"
            rec.events[t] = (_host(lw_prev), _host(xs_prev), _host(xs_in))
        return self._final(out, rec)
