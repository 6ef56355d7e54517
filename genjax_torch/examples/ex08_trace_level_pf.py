"""Trace-level particle filtering: condition a scan model on observations
one step at a time through the GFI (O(1) per step via IndexRequest).

The particles are one batched Scan trace (a key batch of 4096); each
step's ``IndexRequest`` edits step ``t`` of every particle at once."""

import torch

from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference import trace_particle_filter
from genjax_torch.models import kalman_filter, lgssm_model


def main(device=None) -> dict:
    device = resolve_device(device)
    a, q, r, T = 0.9, 0.5, 0.3, 10
    model = lgssm_model(a, q, r, T)
    data = model.simulate(random.key(7, device=device), (0.0, None))
    ys = torch.stack([data.get_choices()[t, "y"] for t in range(T)])

    pf = trace_particle_filter(model, (0.0, None), "y", ys, 4096)
    result = pf(random.key(0, device=device))
    exact, _ = kalman_filter(ys, a, q, r, 0.0, 0.0)
    return {"log_z": float(result.log_z), "exact": float(exact),
            "ess_history": [float(e) for e in result.ess_history]}


if __name__ == "__main__":
    r = main()
    print("logZ:", r["log_z"], " exact:", r["exact"])
    print("ESS history:", [f"{e:.0f}" for e in r["ess_history"]])
