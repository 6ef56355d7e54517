"""Support transforms (bijectors): run gradient samplers in unconstrained
space for positive, interval and simplex latents, with the
change-of-variables term added to the target's log-density (counterpart
of ``genjax_tpu/inference/transforms.py``).

Under a batch every value leads with the batch axes, so a bijector's
``fldj`` gives its log-Jacobian terms elementwise (the shape of ``u``)
and :func:`constrain_choices` sums them over everything behind the
``batch_rank`` leading axes: one term per execution, where the JAX
package, under ``vmap``, sums one execution's leaf whole.

Under a ``Switch`` choice map a branch's leaf exists only in the
executions that take the branch: its log-Jacobian term is gated by
``idx == b`` (the index clamped, as the combinator clamps it), and an
address whose support differs between branches gets a :class:`PerBranch`
spec, one bijector a branch.
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


#: "Absent from this Switch branch", told apart from "present and
#: unconstrained" (``None``) while supports are inferred.
_ABSENT = object()


class PerBranch(NamedTuple):
    """Branch-dependent bijector specs for an address under a ``Switch``
    node whose branches give it different supports (``"x"`` normal in
    branch 0, gamma in branch 1): ``specs[b]`` applies to branch ``b``'s
    leaf, ``None`` is the identity. Nested Switch levels nest
    ``PerBranch`` specs, the outermost level first.
    :func:`infer_transforms` builds them."""

    specs: tuple


def get_bijector(spec) -> Bijector:
    if isinstance(spec, Bijector):
        return spec
    if spec is None:
        return identity
    if isinstance(spec, PerBranch):
        raise ValueError(
            "a PerBranch spec names one bijector per Switch branch: it "
            "resolves at an address under Switch nodes only")
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


def _spec_equal(a, b) -> bool:
    """Support-spec equality that takes tensor-valued interval bounds
    (a uniform site with vector arguments) leaf by leaf."""
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(
            _spec_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    if a is None or b is None:
        return a is b
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        return a.shape == b.shape and bool(torch.equal(a.to(b), b))
    return a == b


def _addr_path(addr) -> tuple:
    return addr if isinstance(addr, tuple) else (addr,)


def _and_gate(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return torch.logical_and(torch.as_tensor(a), torch.as_tensor(b))


def _map_at(chm: ChoiceMap, path: tuple, fn: Callable, gate=None,
            branch: tuple = ()):
    """Replace the leaf at ``path`` with ``fn(value, gate, branch)``,
    returning ``(new_chm, found)``. ``Indexed`` nodes (Scan and Vmap
    choices) are transparent: ``path`` does not name the integer layer,
    and ``fn`` sees the whole stacked leaf. ``gate`` (None: live
    everywhere) is the conjunction of the ``Mask`` flags, ``Filtered``
    selections and Switch branch conditions on the way down; ``branch``
    is the stack of Switch branch indices, the outermost first. One
    address may be found in several branches, each visit gated by its
    own condition."""
    if isinstance(chm, Indexed):
        new_inner, found = _map_at(chm.inner, path, fn, gate, branch)
        return (Indexed(new_inner, chm.idx, chm.n, chm.batch_rank)
                if found else chm), found
    if not path:
        if isinstance(chm, Choice):
            v = chm.v
            if isinstance(v, Mask):
                new = fn(v.value, _and_gate(gate, v.primal_flag()), branch)
                return Choice(Mask.build(new, v.flag)), True
            return Choice(fn(v, gate, branch)), True
        return chm, False
    if isinstance(chm, Static):
        comp, rest = path[0], path[1:]
        for i, (k, sub) in enumerate(zip(chm.keys, chm.submaps)):
            if k == comp:
                new_sub, found = _map_at(sub, rest, fn, gate, branch)
                if not found:
                    return chm, False
                return Static(chm.submaps[:i] + (new_sub,)
                              + chm.submaps[i + 1:], chm.keys), True
        return chm, False
    if isinstance(chm, Or):
        new_left, found = _map_at(chm.left, path, fn, gate, branch)
        if found:
            return Or(new_left, chm.right), True
        new_right, found = _map_at(chm.right, path, fn, gate, branch)
        return (Or(chm.left, new_right) if found else chm), found
    if isinstance(chm, Switch):
        # The gate clamps the index as the combinator does, or an index
        # out of range would mark every branch dead.
        idx = torch.as_tensor(chm.idx).to(torch.int64).clamp(
            0, len(chm.branches) - 1)
        new_branches, found_any = [], False
        for b, br in enumerate(chm.branches):
            nb, found = _map_at(br, path, fn, _and_gate(gate, idx == b),
                                branch + (b,))
            new_branches.append(nb if found else br)
            found_any = found_any or found
        if not found_any:
            return chm, False
        return Switch(chm.idx, tuple(new_branches)), True
    if isinstance(chm, Filtered):
        # A lazy filter gates the leaf's existence by its selection.
        sel = chm.selection
        for comp in path:
            sel = sel(comp)
        new_inner, found = _map_at(chm.inner, path, fn,
                                   _and_gate(gate, sel.check()), branch)
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


def _resolve_spec(spec, branch: tuple) -> Bijector:
    """The bijector of a leaf reached through the Switch branches
    ``branch`` (outermost first): each ``PerBranch`` layer takes one
    branch index, from the outside in."""
    stack = tuple(branch)
    while isinstance(spec, PerBranch):
        if not stack:
            raise ValueError(
                "PerBranch transform spec used at an address that is not "
                "under (enough) Switch nodes.")
        spec, stack = spec.specs[stack[0]], stack[1:]
    return get_bijector(spec)


def _apply_transforms(chm: ChoiceMap, transforms: dict, direction: str,
                      batch_rank: int):
    fldj = None
    out = chm
    for addr, spec in transforms.items():
        terms: list = []

        def fn(v, gate, branch, spec=spec, terms=terms):
            bij = _resolve_spec(spec, branch)
            v = torch.as_tensor(v)
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
    trace's. Under a Switch with a tensor index the branches' supports
    merge: agreeing branches share a plain spec, and an address whose
    branches disagree (or that some branch lacks) gets a
    :class:`PerBranch` spec; a Python-int index has only its branch's
    choices, so only that branch is read. ``exclude(addr) -> bool``
    skips addresses (observed sites); sites without support metadata or
    with non-float values stay untransformed."""
    from genjax_torch.lang.combinators.dimap import DimapTrace
    from genjax_torch.lang.combinators.mask import MaskTrace
    from genjax_torch.lang.combinators.scan import ScanTrace
    from genjax_torch.lang.combinators.switch import SwitchTrace
    from genjax_torch.lang.combinators.vmap import VmapTrace
    from genjax_torch.lang.distributions.distribution import (
        DistributionTrace,
    )
    from genjax_torch.lang.static import StaticTrace

    out: dict = {}

    def walk(tr, path, sink):
        if isinstance(tr, StaticTrace):
            for addr, sub in zip(tr.addresses, tr.subtraces):
                walk(sub, path + (addr,), sink)
        elif isinstance(tr, (ScanTrace, VmapTrace, DimapTrace, MaskTrace)):
            walk(tr.inner, path, sink)
        elif isinstance(tr, SwitchTrace):
            idx = tr.get_idx()
            if isinstance(idx, int):
                walk(tr.subtraces[idx], path, sink)
                return
            per = []
            for sub in tr.subtraces:
                d: dict = {}
                walk(sub, path, d)
                per.append(d)
            seen: list = []  # first-seen order: the fldj sum's order
            for d in per:
                seen.extend(a for a in d if a not in seen)
            for addr in seen:
                specs = [d.get(addr, _ABSENT) for d in per]
                present = [s for s in specs if s is not _ABSENT]
                nested = any(isinstance(s, PerBranch) for s in present)
                if (not nested and len(present) == len(specs)
                        and all(_spec_equal(s, present[0])
                                for s in present)):
                    sink[addr] = present[0]
                else:
                    # Every Switch level with a PerBranch beneath gets
                    # its own layer, so layers peel in step with the
                    # branch stack (_resolve_spec).
                    sink[addr] = PerBranch(tuple(
                        None if s is _ABSENT else s for s in specs))
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
            # None (present, unconstrained) is kept through the walk so
            # that a Switch merge tells it from an absent site.
            sink[addr] = spec

    walk(trace, (), out)
    return {a: s for a, s in out.items() if s is not None}


def path_present(chm, addr) -> bool:
    """Whether an address (flat or tuple path) resolves to a value in
    ``chm``, by the ``Indexed``-transparent lookup of
    :func:`constrain_choices`."""
    _, found = _map_at(chm, _addr_path(addr), lambda v, gate, branch: v)
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

