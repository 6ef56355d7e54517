"""Cookbook 2 — Choice maps: building, reading, combining.

A ChoiceMap is the random database of a trace: a mapping from addresses
(the ``@ "name"`` labels in a model) to values. Observations,
constraints, and posterior samples are all choice maps. This page is
the algebra tour; implementation ``genjax_torch/gfi/choice_map.py``.
"""

import torch

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.utils import pformat


@g.gen
def kernel(mu):
    return g.normal(mu, 1.0) @ "z"


@g.gen
def model():
    x = g.normal(0.0, 1.0) @ "x"
    g.normal(x, 0.1) @ "y"
    return x


def main(device=None) -> dict:
    device = resolve_device(device)
    out = {}

    def t(v):
        return torch.as_tensor(v, device=device)

    # -- building --------------------------------------------------------
    # `g.C` builds maps address by address; `|` merges.
    c1 = g.C["x"].set(t(1.0))                    # one scalar choice
    c2 = g.C["obs", "y"].set(torch.ones(3, device=device))  # nested address
    c3 = g.ChoiceMap.kw(a=t(0.5), b=t(2.0))     # from keywords
    c4 = g.ChoiceMap.from_mapping([("u", t(1.0)), (("v", "w"), t(2.0))])
    merged = c1 | c2 | c3 | c4
    out["merged"] = pformat(merged)

    # Reading uses indexing; nested addresses chain.
    assert merged["x"] == 1.0
    assert merged["obs", "y"].shape == (3,)
    assert merged["v", "w"] == 2.0

    # Missing addresses raise (a static error, not a silent None):
    try:
        merged["nope"]
    except g.ChoiceMapNoValueAtAddress:
        out["missing_raises"] = True

    # `|` is a PRIORITY union: the left side wins at overlapping addresses.
    override = g.C["x"].set(t(99.0)) | merged
    assert override["x"] == 99.0

    # -- filtering by selection ------------------------------------------
    # Selections (`g.S`) describe address sets; filter keeps the selected
    # part. Complement with `~`.
    sel = g.S.at["x"] | g.S.at["obs"]
    kept = merged.filter(sel)
    dropped = merged.filter(~sel)
    assert kept["x"] == 1.0
    try:
        dropped["x"]
    except g.ChoiceMapNoValueAtAddress:
        pass
    assert dropped["a"] == 0.5

    # -- vmapped models: Indexed lanes ------------------------------------
    # Choices made under `vmap`/`scan` combinators get a lane axis;
    # indexing with an integer first selects the lane.
    vm = kernel.vmap(in_axes=0)
    tr = vm.simulate(random.key(0, device=device),
                     (torch.arange(4.0, device=device),))
    lanes = tr.get_choices()
    assert lanes[2, "z"].shape == ()          # lane 2's choice
    assert lanes[:, "z"].shape == (4,)        # all lanes, stacked
    out["lanes"] = pformat(lanes)
    out["lanes_z"] = lanes[:, "z"].tolist()

    # Writing lane-targeted constraints uses the same syntax:
    constraint = g.C[2, "z"].set(t(10.0))    # only lane 2 is constrained
    tr2, _ = vm.generate(random.key(1, device=device), constraint,
                         (torch.arange(4.0, device=device),))
    assert tr2.get_choices()[2, "z"] == 10.0

    # -- masks: optionality with fixed shapes -----------------------------
    # "Maybe a value" is a Mask (value + boolean flag), not a missing
    # entry. Branch-dependent choices (switch), masked iteration, and
    # lane-partial constraints all produce masks; `unmask` unwraps.
    m = g.Mask(t(3.0), t(True))
    assert m.unmask() == 3.0

    # -- choice maps in inference ------------------------------------------
    # Observations are just choice maps handed to `generate`/`Target`:
    obs = g.C["y"].set(t(0.8))
    tr3, w3 = model.generate(random.key(2, device=device), obs, ())
    # ...and posterior samples come back out as choice maps:
    posterior_x = tr3.get_choices().filter(~g.S.at["y"])
    out.update(posterior_x=float(posterior_x["x"]), weight=float(w3))
    return out


if __name__ == "__main__":
    r = main()
    print(r["merged"])
    if r.get("missing_raises"):
        print("missing address raises ChoiceMapNoValueAtAddress")
    print(r["lanes"])
    print("posterior draw:", r["posterior_x"], " weight:", r["weight"])
    print("ok")
