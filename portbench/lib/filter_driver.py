"""What the drivers of the port's particle filters share
(``drivers/<driver>.py``; a traffic mix names its driver).

A driver is the harness's one handle on the system under test. The
harness (``run.py``, ``control.py``) uses nothing else of it:

- ``Driver(cfg, mix, device, seed)``, then ``setup()``: the port's filter
  built as ``genjax_torch/entry.py`` builds it, on inputs that the
  configuration's reference module makes (``configs/<config>.py``'s
  ``inputs``) and that the reference reads too;
- ``call(key) -> out``: one call, not synchronised; ``failed(out)``;
- ``record(on)``: whether the next call keeps what the judge reads;
  ``keep(out)``: after that call, what it kept, moved to the host (a
  :class:`~portbench.reference.filters.Record`);
- ``judge(kept)``: the reference's readings over ``[(key, record)]``,
  each the widest over them; ``control(key, dtype)``: the reference put
  in the program's place in ``dtype``, as a record;
- ``release()``; ``work`` (particle-steps a call), ``steps``, ``n``.

A filter call returns the port's public ``(FilterState, log_z per
step)``. What the judge needs of the steps between comes from the
public hooks of the port's drivers where they have them (the batched
``particle_filter``'s ``resample_fn``, documented in its docstring) and
from the fused step's own boundary otherwise (``drivers/fused_pf.py``),
never from a private name of the port.
"""

from __future__ import annotations

import importlib

import torch

from portbench.lib import plugins
from portbench.reference import filters


class FilterDriver:
    #: The propagation's noise stream, as the reference draws it.
    noise = "keyed"

    def __init__(self, cfg: dict, mix: dict, device, seed: int):
        self.cfg, self.mix, self.device, self.seed = cfg, mix, device, seed
        self.n = int(mix["particles"])
        self.threshold = float(mix.get("ess_threshold", 0.5))
        self.state_dtype = getattr(torch, mix.get("state_dtype", "float32"))
        self.ref = plugins.module("configs", cfg["name"])
        self.inputs = self.ref.inputs(cfg, mix, device)
        self.model = self.ref.filter_model(cfg, self.inputs, self.noise,
                                           device)
        self.steps = self.model.steps
        #: Particle-steps a call, as the port's entry points count them
        #: (one an observation).
        self.work = self.n * cfg["steps"]
        self.pf = None
        self._kept = None          # what the recorded call keeps
        self._undo = []

    # -- the port -----------------------------------------------------

    def setup(self):
        raise NotImplementedError

    def call(self, key):
        return self.pf(key, self.inputs["observations"])

    def failed(self, out) -> bool:
        return not bool(torch.isfinite(out[0].log_z))

    def release(self):
        self.pf = None
        self._kept = None
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()

    def wrap(self, module_name: str, name: str, new_of_old):
        """Put ``new_of_old(old)`` in the place of ``module.name`` until
        :meth:`release`."""
        mod = importlib.import_module(module_name)
        self._undo.append(plugins.patch(mod, name,
                                        new_of_old(getattr(mod, name))))

    def resample_hook(self):
        """A ``resample_fn`` for the port's ``particle_filter`` doing
        what its default does (the public ``smc.resample_tree``,
        systematic), and keeping its input and output when recording."""
        smc = importlib.import_module("genjax_torch.inference.smc")
        n = self.n

        def resample_fn(key, lw, particles):
            out = smc.resample_tree(key, lw, particles, n, "systematic")
            if self._kept is not None:
                self._kept.append((key, lw, particles, out))
            return out

        return resample_fn

    # -- what the judge reads -----------------------------------------

    def record(self, on: bool):
        self._kept = [] if on else None

    def keep(self, out) -> filters.Record:
        """The recorded call as a record on the host."""
        raise NotImplementedError

    def _final(self, out, rec: filters.Record) -> filters.Record:
        final, log_zs = out[0], out[1]
        rec.final = (_host(final.particles), _host(final.log_weights))
        rec.log_zs = _host(log_zs)
        self._kept = None
        return rec

    def judge(self, kept) -> dict:
        worst = filters.Readings(self.model.discrete)
        for key, record in kept:
            rd = filters.run_filter(self.model, key.to(self.device), self.n,
                                    self.steps, self.threshold,
                                    torch.float64, follow=record)
            for k, v in rd.v.items():
                worst.put(k, v)
        return worst.v

    def control(self, key, dtype) -> filters.Record:
        rec = filters.run_filter(self.model, key.to(self.device), self.n,
                                 self.steps, self.threshold, dtype)
        rec.events = {t: tuple(_host(v) for v in ev)
                      for t, ev in rec.events.items()}
        rec.final = tuple(_host(v) for v in rec.final)
        rec.log_zs = _host(rec.log_zs)
        return rec


class HookedFilterDriver(FilterDriver):
    """A driver whose filter takes the resampling hook: the kept
    resamplings are placed by their keys."""

    def call(self, key):
        self._key = key
        return super().call(key)

    def keep(self, out) -> filters.Record:
        """The hook's kept ``(key, log_weights, particles, resampled)``,
        each placed at the step whose resampling key it got."""
        rec = filters.Record()
        _, k_res, _ = filters.filter_keys(self._key, self.steps)
        for key, lw, particles, resampled in self._kept or ():
            t = filters.step_of_key(key, k_res)
            if t is None or t in rec.events:
                rec.broken = "a resampling on no step's key"
                continue
            rec.events[t] = (_host(lw), _host(particles), _host(resampled))
        return self._final(out, rec)


def _host(v: torch.Tensor) -> torch.Tensor:
    return v.detach().to("cpu")
