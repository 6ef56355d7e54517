"""Driver ``hmm_pf``: the port's discrete-HMM bootstrap filter,
``models.hmm.hmm_bootstrap_filter`` (inverse-CDF transitions, one key a
step for the whole ensemble), on the configuration's circulant HMM as
``genjax_torch/entry.py``'s ``build_hmm_smc`` builds it, on the
observations the configuration's reference module draws. The
resampling goes through the documented ``resample_fn`` hook of the
``particle_filter`` beneath it, which does what its default does and
keeps what the judge reads.
"""

from __future__ import annotations

import importlib

from portbench.lib.filter_driver import HookedFilterDriver


class Driver(HookedFilterDriver):
    noise = "keyed"

    def setup(self):
        hmm = importlib.import_module("genjax_torch.models.hmm")
        from genjax_torch.lang.distributions.discrete_hmm import (
            DiscreteHMMConfiguration)

        cfg = self.cfg
        config = DiscreteHMMConfiguration.circulant(
            cfg["num_states"], cfg["num_obs"],
            transition_variance=cfg["transition_variance"],
            observation_variance=cfg["observation_variance"],
            device=self.device)
        self.pf = hmm.hmm_bootstrap_filter(config, self.n,
                                           ess_threshold=self.threshold,
                                           resample_fn=self.resample_hook())
