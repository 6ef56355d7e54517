"""``mix``: a mixture of generative functions, a categorical draw over
the components followed by a ``Switch`` on it (counterpart of
``genjax_tpu/lang/combinators/mixture.py``). The component sits at
``"mixture_component"``, the chosen component's choices at
``"mixture_branch"``.
"""

from __future__ import annotations

from genjax_torch.gfi.gfn import GenerativeFunction
from genjax_torch.lang.combinators.switch import Switch
from genjax_torch.lang.static import gen

__all__ = ["mix"]

#: One mixture per component tuple. Function-valued fields compare by
#: identity, so a fresh ``mixture`` per construction would give traces of
#: ``c0.mix(c1)(...) @ "m"`` inside a ``@gen`` body a new structure on
#: every execution, which the MH accept select refuses. The cache keeps
#: every entry: a cleared cache would hand out a second identity for the
#: same components.
_MIX_CACHE: dict = {}


def mix(*fns: GenerativeFunction) -> GenerativeFunction:
    """Arguments ``(logits, branch0_args, branch1_args, ...)``: draws a
    component from ``categorical(logits)``, then runs that branch."""
    from genjax_torch.core.argcheck import check_gen_fns

    check_gen_fns(fns, "mix")
    try:
        cached = _MIX_CACHE.get(fns)
    except TypeError:  # an unhashable component: no cache
        cached = None
    if cached is not None:
        return cached
    from genjax_torch.lang.distributions import categorical

    sw = Switch(tuple(fns))

    @gen
    def mixture(logits, *branch_args):
        idx = categorical(logits) @ "mixture_component"
        return sw(idx, *branch_args) @ "mixture_branch"

    try:
        _MIX_CACHE[fns] = mixture
    except TypeError:
        pass
    return mixture
