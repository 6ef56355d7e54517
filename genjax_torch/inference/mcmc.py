"""MCMC: Metropolis–Hastings accept/reject over edit requests and
chain runners (counterpart of ``genjax_tpu/inference/mcmc.py``).

The chain axis is a key batch: a trace built on keys ``B + (2,)`` holds
``B`` chains, one MH step draws one acceptance per chain, and the accept
select broadcasts ``accept`` (shape ``B``) against each leaf's
``B + event`` by the batch rank. ``lax.scan`` becomes a Python loop.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from genjax_torch.core import random
from genjax_torch.core.pytree import tree_flatten, tree_map, tree_unflatten
from genjax_torch.gfi.concepts import EditRequest
from genjax_torch.gfi.gfn import Trace

__all__ = ["mh", "chain", "multi_chain", "select_accept"]


def select_accept(accept: torch.Tensor, new_tr, old_tr, invariant=None):
    """Leafwise ``where(accept, new, old)``, ``accept`` of the batch's
    shape set against each leaf's leading axes. The two traces must have
    the same structure (it raises when they differ). A leaf marked in
    ``invariant`` (the same in both traces, as the constrained values an
    edit keeps) is taken from ``old`` without a select."""
    new_leaves, new_spec = tree_flatten(new_tr)
    old_leaves, old_spec = tree_flatten(old_tr)
    if new_spec != old_spec:
        raise ValueError("MH: the proposed trace differs in structure from "
                         "the current one")
    inv = (tree_flatten(invariant)[0] if invariant is not None
           else [False] * len(old_leaves))
    rank = accept.ndim

    def pick(n, o, i):
        if i or n is o:
            return o
        if not isinstance(n, torch.Tensor) and not isinstance(o, torch.Tensor):
            if n == o:
                return o
        n = torch.as_tensor(n, device=accept.device)
        o = torch.as_tensor(o, device=accept.device)
        nd = max(n.ndim, o.ndim, rank)
        a = accept.reshape(tuple(accept.shape) + (1,) * (nd - rank))
        return torch.where(a, n, o)

    return tree_unflatten([pick(n, o, i) for n, o, i in
                           zip(new_leaves, old_leaves, inv)], old_spec)


def mh(key, trace: Trace[Any], request: EditRequest):
    """One Metropolis–Hastings step: ``request`` proposes, and each chain
    accepts with probability ``min(1, exp(weight))``. Returns ``(trace,
    accepted)``."""
    key, accept_key = random.split(key).unbind(-2)
    new_trace, w, _, _ = trace.edit(key, request)
    accept = torch.log(random.uniform(accept_key, ())) < w
    return select_accept(accept, new_trace, trace), accept


def chain(kernel: Callable):
    """Lift a kernel ``(key, trace) -> (trace, aux)`` into a runner
    ``(key, trace, n_steps) -> (final_trace, stacked_aux)``; step ``i``
    uses ``fold_in(key, i)``."""

    def run(key, trace: Trace[Any], *, n_steps: int, burn_in: int = 0,
            collect: Callable | None = None):
        """``n_steps`` kernel applications in all; the first ``burn_in``
        collect nothing."""
        outs = []
        for i in range(n_steps):
            trace, aux = kernel(random.fold_in(key, i), trace)
            if i >= burn_in:
                outs.append(collect(trace) if collect is not None else aux)
        if not outs:
            return trace, None
        # The step axis follows the chains' batch axes (the key's).
        r = key.ndim - 1
        return trace, tree_map(lambda *vs: torch.stack(
            [torch.as_tensor(v) for v in vs], dim=r), *outs)

    return run


def multi_chain(kernel, n_chains: int):
    """``n_chains`` independent chains as one key batch: chain ``i`` starts
    from ``trace_init_fn`` on ``fold_in(key, i)`` and runs on
    ``fold_in(fold_in(key, i), 0x5EED)``. ``trace_init_fn`` takes the
    ``(n_chains, 2)`` keys and returns the batched initial traces."""
    runner = chain(kernel)

    def run(key, trace_init_fn, *, n_steps: int, burn_in: int = 0,
            collect=None):
        keys = random.fold_in(key.unsqueeze(-2),
                              torch.arange(n_chains, device=key.device))
        return runner(random.fold_in(keys, 0x5EED), trace_init_fn(keys),
                      n_steps=n_steps, burn_in=burn_in, collect=collect)

    return run
