"""Support transforms (bijectors): run gradient samplers in unconstrained
space for positive, interval and simplex latents, with the
change-of-variables term added to the target's log-density (counterpart
of ``genjax_tpu/inference/transforms.py``).

Under a batch every value leads with the batch axes, so a bijector's
``fldj`` gives its log-Jacobian terms elementwise (the shape of ``u``)
and :func:`constrain_choices` sums them over everything behind the
``batch_rank`` leading axes: one term per execution, where the JAX
package, under ``vmap``, sums one execution's leaf whole.

Not ported yet: ``Switch`` choice maps and the branch-dependent
``PerBranch`` specs. Both raise; they come with the combinators slice
(ROADMAP queue 1 item 2).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from genjax_torch.core import random
from genjax_torch.core.pytree import event_sum, tree_leaves
from genjax_torch.gfi.choice_map import (
    Choice,
    ChoiceMap,
    Empty,
    Filtered,
    Indexed,
    Or,
    Static,
    Switch,
)
from genjax_torch.gfi.mask import Mask

__all__ = ["Bijector", "identity", "positive", "interval", "simplex",
           "PerBranch", "get_bijector", "constrain_choices",
           "unconstrain_choices", "infer_transforms", "path_present",
           "resolve_transforms"]

_COMBINATORS_SLICE = ("ROADMAP queue 1 item 2, the combinators slice "
                      "(Switch, mix, or_else)")


class Bijector(NamedTuple):
    """u (unconstrained) <-> x (constrained). ``fldj(u)`` is
    ``log |d forward / du|`` elementwise, in the shape of ``u``."""

    forward: Callable   # u -> x
    inverse: Callable   # x -> u
    fldj: Callable      # u -> log-Jacobian terms, shape of u


identity = Bijector(
    forward=lambda u: u,
    inverse=lambda x: x,
    fldj=lambda u: torch.zeros_like(u),
)

#: (0, ∞) by softplus.
positive = Bijector(
    forward=F.softplus,
    inverse=lambda x: x + torch.log(-torch.expm1(-x)),
    fldj=F.logsigmoid,
)


def interval(low, high) -> Bijector:
    """(low, high) by a scaled sigmoid."""
    width = high - low

    def fldj(u):
        return (torch.log(torch.as_tensor(width, dtype=u.dtype,
                                          device=u.device))
                + F.logsigmoid(u) + F.logsigmoid(-u))

    return Bijector(
        forward=lambda u: low + width * torch.sigmoid(u),
        inverse=lambda x: torch.logit((x - low) / width),
        fldj=fldj,
    )


def _stick_breaking_offsets(km1: int, like: torch.Tensor) -> torch.Tensor:
    # Stan's offsets: u = 0 maps to the uniform simplex.
    return -torch.log(torch.arange(km1, 0, -1, dtype=like.dtype,
                                   device=like.device))


def _simplex_forward(u):
    """u ∈ R^{K-1} → x ∈ Δ^{K-1} (K components) by stick-breaking."""
    z = torch.sigmoid(u + _stick_breaking_offsets(u.shape[-1], u))
    cp = torch.cat([torch.ones_like(u[..., :1]),
                    torch.cumprod(1.0 - z, dim=-1)], dim=-1)
    return torch.cat([z * cp[..., :-1], cp[..., -1:]], dim=-1)


def _simplex_inverse(x):
    # The remaining mass is a suffix sum of positive terms (1 − cumsum
    # cancels once the tail sticks shrink below f32 epsilon), and
    # logit(z_k) = log(x_k) − log(rem_{k+1}).
    head = x[..., :-1]
    tail = torch.flip(torch.cumsum(torch.flip(x, (-1,)), dim=-1),
                      (-1,))[..., 1:]
    tiny = torch.finfo(x.dtype).tiny
    return (torch.log(torch.clamp(head, min=tiny))
            - torch.log(torch.clamp(tail, min=tiny))
            - _stick_breaking_offsets(head.shape[-1], x))


def _simplex_fldj(u):
    # Triangular Jacobian: |J| = Π_k σ'(t_k) · (remaining stick)_k.
    t = u + _stick_breaking_offsets(u.shape[-1], u)
    z = torch.sigmoid(t)
    cp = torch.cat([torch.ones_like(u[..., :1]),
                    torch.cumprod(1.0 - z, dim=-1)[..., :-1]], dim=-1)
    return F.logsigmoid(t) + F.logsigmoid(-t) + torch.log(cp)


#: Δ^{K-1} by stick-breaking (Stan's offsets): the unconstrained side has
#: K-1 dimensions for K components.
simplex = Bijector(
    forward=_simplex_forward,
    inverse=_simplex_inverse,
    fldj=_simplex_fldj,
)

_NAMED = {"identity": identity, "positive": positive, "simplex": simplex}


class PerBranch(NamedTuple):
    """Branch-dependent bijector specs for an address under a ``Switch``
    node. Not ported yet: a spec of this kind raises."""

    specs: tuple


def get_bijector(spec) -> Bijector:
    if isinstance(spec, Bijector):
        return spec
    if spec is None:
        return identity
    if isinstance(spec, PerBranch):
        raise NotImplementedError(
            f"PerBranch transform specs are not ported yet: they come with "
            f"{_COMBINATORS_SLICE}")
    if isinstance(spec, str):
        if spec == "unit_interval":
            return interval(0.0, 1.0)
        try:
            return _NAMED[spec]
        except KeyError:
            raise ValueError(f"Unknown bijector spec: {spec!r}") from None
    if isinstance(spec, tuple) and len(spec) == 2:
        return interval(*spec)
    raise ValueError(f"Unknown bijector spec: {spec!r}")


def _addr_path(addr) -> tuple:
    return addr if isinstance(addr, tuple) else (addr,)


def _and_gate(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return torch.logical_and(torch.as_tensor(a), torch.as_tensor(b))


def _map_at(chm: ChoiceMap, path: tuple, fn: Callable, gate=None):
    """Replace the leaf at ``path`` with ``fn(value, gate)``, returning
    ``(new_chm, found)``. ``Indexed`` nodes (Scan and Vmap choices) are
    transparent: ``path`` does not name the integer layer, and ``fn``
    sees the whole stacked leaf. ``gate`` (None: live everywhere) is the
    conjunction of the ``Mask`` flags and ``Filtered`` selections on
    the way down."""
    if isinstance(chm, Indexed):
        new_inner, found = _map_at(chm.inner, path, fn, gate)
        return (Indexed(new_inner, chm.idx, chm.n, chm.batch_rank)
                if found else chm), found
    if not path:
        if isinstance(chm, Choice):
            v = chm.v
            if isinstance(v, Mask):
                new = fn(v.value, _and_gate(gate, v.primal_flag()))
                return Choice(Mask.build(new, v.flag)), True
            return Choice(fn(v, gate)), True
        return chm, False
    if isinstance(chm, Static):
        comp, rest = path[0], path[1:]
        for i, (k, sub) in enumerate(zip(chm.keys, chm.submaps)):
            if k == comp:
                new_sub, found = _map_at(sub, rest, fn, gate)
                if not found:
                    return chm, False
                return Static(chm.submaps[:i] + (new_sub,)
                              + chm.submaps[i + 1:], chm.keys), True
        return chm, False
    if isinstance(chm, Or):
        new_left, found = _map_at(chm.left, path, fn, gate)
        if found:
            return Or(new_left, chm.right), True
        new_right, found = _map_at(chm.right, path, fn, gate)
        return (Or(chm.left, new_right) if found else chm), found
    if isinstance(chm, Switch):
        raise NotImplementedError(
            "support transforms through Switch choice maps are not ported "
            f"yet: they come with {_COMBINATORS_SLICE}")
    if isinstance(chm, Filtered):
        # A lazy filter gates the leaf's existence by its selection.
        sel = chm.selection
        for comp in path:
            sel = sel(comp)
        new_inner, found = _map_at(chm.inner, path, fn,
                                   _and_gate(gate, sel.check()))
        return (Filtered(new_inner, chm.selection) if found else chm), found
    if isinstance(chm, (Empty, Choice)):
        return chm, False
    raise NotImplementedError(
        f"Support transforms through {type(chm).__name__} nodes are not "
        "supported.")


def _gate_like(gate, t: torch.Tensor) -> torch.Tensor:
    """A flag set against ``t``'s leading axes (it covers the batch and
    the lanes in front)."""
    g = torch.as_tensor(gate, device=t.device)
    return g.reshape(tuple(g.shape) + (1,) * (t.ndim - g.ndim))


def _safe_inverse(bij: Bijector, v, gate):
    """``bij.inverse(v)`` where ``gate`` holds, 0 elsewhere: a dead
    leaf's placeholder is replaced by an in-domain probe (``forward(0)``)
    before inverting, so that no NaN appears."""
    with torch.no_grad():
        u_shape = bij.inverse(v).shape
    probe = bij.forward(torch.zeros(u_shape, dtype=v.dtype, device=v.device))
    u = bij.inverse(torch.where(_gate_like(gate, v), v, probe))
    return torch.where(_gate_like(gate, u), u, torch.zeros_like(u))


def _apply_transforms(chm: ChoiceMap, transforms: dict, direction: str,
                      batch_rank: int):
    fldj = None
    out = chm
    for addr, spec in transforms.items():
        bij = get_bijector(spec)
        terms: list = []

        def fn(v, gate, bij=bij, terms=terms):
            if direction == "forward":
                t = bij.fldj(v)
                if gate is not None:
                    t = torch.where(_gate_like(gate, t), t,
                                    torch.zeros_like(t))
                terms.append(event_sum(t, batch_rank))
                return bij.forward(v)
            if gate is None:
                return bij.inverse(v)
            return _safe_inverse(bij, v, gate)

        out, found = _map_at(out, _addr_path(addr), fn)
        if not found:
            raise KeyError(
                f"Transform address {addr!r} not present in choice map.")
        for t in terms:
            fldj = t if fldj is None else fldj + t
    if fldj is None:
        fldj = torch.zeros(())
    return out, fldj


def constrain_choices(chm_u: ChoiceMap, transforms: dict,
                      batch_rank: int = 0):
    """Map the addresses of ``transforms`` (flat, tuple paths, or paths
    through Scan / Vmap ``Indexed`` layers) from unconstrained to
    constrained values. Returns ``(chm_x, fldj)``, the log-Jacobian
    summed behind the ``batch_rank`` leading axes."""
    return _apply_transforms(chm_u, transforms, "forward", batch_rank)


def unconstrain_choices(chm_x: ChoiceMap, transforms: dict) -> ChoiceMap:
    """The inverse of :func:`constrain_choices` (no Jacobian)."""
    out, _ = _apply_transforms(chm_x, transforms, "inverse", 0)
    return out


def infer_transforms(trace, *, exclude=None) -> dict:
    """A transforms dict from the support metadata of the distributions
    in ``trace``: nested ``@gen`` subtraces give tuple addresses, Scan and
    Vmap sites their inner site's path, Dimap and Mask their inner
    trace's. ``exclude(addr) -> bool`` skips addresses (observed sites);
    sites without support metadata or with non-float values stay
    untransformed."""
    from genjax_torch.lang.combinators.dimap import DimapTrace
    from genjax_torch.lang.combinators.mask import MaskTrace
    from genjax_torch.lang.combinators.scan import ScanTrace
    from genjax_torch.lang.combinators.vmap import VmapTrace
    from genjax_torch.lang.distributions.distribution import (
        DistributionTrace,
    )
    from genjax_torch.lang.static import StaticTrace

    out: dict = {}

    def walk(tr, path):
        if isinstance(tr, StaticTrace):
            for addr, sub in zip(tr.addresses, tr.subtraces):
                walk(sub, path + (addr,))
        elif isinstance(tr, (ScanTrace, VmapTrace, DimapTrace, MaskTrace)):
            walk(tr.inner, path)
        elif isinstance(tr, DistributionTrace):
            v = tr.get_retval()
            if isinstance(v, Mask):
                v = v.value
            if not torch.as_tensor(v).is_floating_point():
                return
            spec = tr.get_gen_fn().get_support(*tr.get_args())
            if spec == "unit_interval":
                spec = (0.0, 1.0)
            addr = path[0] if len(path) == 1 else path
            if exclude is not None and exclude(addr):
                return
            out[addr] = spec

    walk(trace, ())
    return {a: s for a, s in out.items() if s is not None}


def path_present(chm, addr) -> bool:
    """Whether an address (flat or tuple path) resolves to a value in
    ``chm``, by the ``Indexed``-transparent lookup of
    :func:`constrain_choices`."""
    _, found = _map_at(chm, _addr_path(addr), lambda v, gate: v)
    return found


def tree_device(tree):
    """The device of the first tensor leaf of ``tree`` (None if none)."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def resolve_transforms(target, transforms):
    """The ``transforms`` argument of the gradient fitters: ``None`` gives
    ``{}``, a dict passes, and ``"auto"`` derives the dict from the
    target's support metadata with the observed addresses left out."""
    if transforms == "auto":
        dev = tree_device((target.args, target.constraint))
        probe_tr, _ = target.importance(random.key(0, device=dev),
                                        ChoiceMap.empty())
        latents = target.filter_to_unconstrained(probe_tr.get_choices())
        return infer_transforms(
            probe_tr, exclude=lambda addr: not path_present(latents, addr))
    if isinstance(transforms, str):
        raise ValueError(
            f"transforms={transforms!r}: expected a dict, None, or the "
            'string "auto".')
    return transforms or {}

