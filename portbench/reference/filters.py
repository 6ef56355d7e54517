"""The plain bootstrap particle filter with adaptive systematic
resampling, written from its definition in plain PyTorch, which judges
what the port's filters produced.

``run_filter`` runs a model (a configuration's reference, ``configs/
<config>.py``) in a given precision. Alone it is the control: the
filter computed in a lower precision and put in the program's place,
producing what the harness keeps of the program (a :class:`Record`).
Given a ``follow`` record it is the judge: it runs in float64 and, at
each resampling the program made, reads how far the program's weights
and states lie from its own and how far the program's offspring counts
lie from its own float64 counts of the program's weights, then goes on
from the program's resampled ensemble, so that it follows the program
step by step from the program's own state (the tracking model amplifies
rounding up to 25 times a step near 0, so two runs that part never meet
again). Between resamplings it propagates and weighs with its own
arithmetic; its log Z sums its own weights, and it reads the gap of the
program's log Z after every step. The initial ensemble is its own, so
the first stretch checks the start.

It imports nothing of the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from portbench.reference import threefry


@dataclass
class Record:
    """One filter call as the harness keeps it (the program's or the
    control's): ``events[t] = (log_weights, states, resampled states)``
    of a resampling before step ``t``'s propagation, ``final`` the last
    step's ``(states, log_weights)``, ``log_zs`` the running log Z after
    each step, and ``broken`` a reason where what the program did is no
    filter call at all (the judge then reads it as failed)."""

    events: dict = field(default_factory=dict)
    final: tuple | None = None
    log_zs: torch.Tensor | None = None
    broken: str | None = None


def filter_keys(key: torch.Tensor, n_steps: int):
    """``(k_init, k_res[t], k_prop[t])``: ``split(key)``, then
    ``split(fold_in(k_scan, t))`` for each step."""
    k_init, k_scan = threefry.split(key).unbind(-2)
    steps = threefry.split(threefry.fold_in(
        k_scan[None, :], torch.arange(n_steps, device=key.device)))
    return k_init, steps[:, 0], steps[:, 1]


def step_of_key(key: torch.Tensor, k_res: torch.Tensor):
    """The step ``t`` whose resampling key ``k_res[t]`` is ``key``, or
    None."""
    hit = (k_res.to(key.device) == key[None, :]).all(-1).nonzero()
    return int(hit[0, 0]) if hit.numel() else None


def systematic_counts(key: torch.Tensor, lw: torch.Tensor, n: int,
                      dtype=torch.float64) -> torch.Tensor:
    """Inclusive cumulative offspring counts of systematic resampling:
    ``ceil(cum · n / total − u0)`` clipped to ``[0, n]`` over the running
    sum of the normalised weights (kept monotone), the last pinned to
    ``n``; ``u0`` the float32 uniform of the key. int64."""
    w = torch.exp((lw - lw.max()).to(dtype))
    cum = torch.cummax(torch.cumsum(w, 0), 0).values
    u0 = threefry.uniform(key).to(dtype)
    cc = torch.clamp(torch.ceil(cum * (n / cum[-1]) - u0), 0, n).to(
        torch.int64)
    cc[-1] = n
    return cc


def expand(states: torch.Tensor, counts_cum: torch.Tensor) -> torch.Tensor:
    """Each particle repeated by its offspring count."""
    counts = torch.diff(counts_cum.to(torch.int64),
                        prepend=counts_cum.new_zeros(1))
    return torch.repeat_interleave(states, counts, dim=0)


def offspring_gap(states: torch.Tensor, resampled: torch.Tensor,
                  counts_cum: torch.Tensor) -> float:
    """The widest gap between the program's offspring count of each
    distinct state value (how many of ``resampled`` hold it) and the
    count that ``counts_cum`` gives the particles of ``states`` holding
    it. It needs nothing of how the program resampled: only its input
    and output. A resampled value that no input particle holds, or an
    output of another size, reads inf. A continuous state's values are
    its particles (a count a particle); a discrete one's, its states."""
    if resampled.shape != states.shape or resampled.dtype != states.dtype:
        return math.inf
    if states.is_floating_point() and not bool(
            torch.isfinite(states).all() and torch.isfinite(resampled).all()):
        return math.inf
    vals, inv = torch.unique(states, return_inverse=True)
    pos = torch.searchsorted(vals, resampled).clamp_max(vals.numel() - 1)
    if not bool((vals[pos] == resampled).all()):
        return math.inf
    theirs = torch.bincount(pos, minlength=vals.numel())
    counts = torch.diff(counts_cum.to(torch.int64),
                        prepend=counts_cum.new_zeros(1))
    ours = torch.zeros_like(theirs).index_add_(0, inv, counts)
    return float((theirs - ours).abs().max())


def _lse(lw: torch.Tensor, dtype) -> torch.Tensor:
    return torch.logsumexp(lw.to(dtype), 0)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The widest gap of ``a`` from ``b`` relative to ``1 + |b|``."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    gap = ((a - b).abs() / (1.0 + b.abs())).max()
    return float(gap) if torch.isfinite(gap) else math.inf


#: A discrete state's weight is a sum of table entries, exact to float32
#: rounding (about 1e-7 relative) while the particle's path is the
#: reference's; one that is off by more has another path.
WEIGHT_OFF = 1e-4


def _off_share(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of particles whose weight lies more than
    :data:`WEIGHT_OFF` from the reference's, relative to ``1 + |b|``."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    off = ~((a - b).abs() <= WEIGHT_OFF * (1.0 + b.abs()))
    return float(off.double().mean())


class Readings:
    """The widest gaps a judge read, one number each."""

    NAMES = ("log_z_gap", "weight_gap", "state_gap", "counts_gap")

    def __init__(self, discrete: bool):
        self.discrete = discrete
        self.v = {k: 0.0 for k in self.NAMES}

    def put(self, name: str, value: float):
        if not value <= self.v[name]:      # NaN and inf win
            self.v[name] = value

    def fail(self):
        for k in self.NAMES:
            self.v[k] = math.inf

    def states(self, prog: torch.Tensor, ref: torch.Tensor,
               lw_prog=None, lw_ref=None):
        """States and (where given) weights of one ensemble: for a
        discrete state the share of particles whose state differs and the
        share whose weight is off (a state's rounding in float32 against
        float64 now and then sends a particle down a neighbouring path,
        which may meet the reference's again: a widest gap would read
        that as a fault); else the widest relative gaps."""
        if prog.shape != ref.shape:
            self.put("state_gap", math.inf)
            return
        if self.discrete:
            same = prog.to(torch.int64) == ref.to(torch.int64)
            self.put("state_gap", 1.0 - float(same.double().mean()))
            if lw_prog is not None:
                self.put("weight_gap", _off_share(lw_prog, lw_ref))
            return
        self.put("state_gap", _rel(prog, ref))
        if lw_prog is not None:
            self.put("weight_gap", _rel(lw_prog, lw_ref))


#: How near the threshold an effective sample size may lie before the
#: judge takes the program's decision to resample or not as its own.
DECISION_BAND = 1e-4


def run_filter(model, key: torch.Tensor, n: int, n_steps: int,
               threshold: float, dtype=torch.float64,
               follow: Record | None = None):
    """Run ``model``'s bootstrap filter from ``key`` in ``dtype``.
    ``model`` gives ``init(k_init, n, dtype) -> (states, log_weights)``
    and ``step(k_prop, t, states, dtype) -> (states, log_incr)``, and
    ``discrete`` (True for an integer state). Without ``follow`` returns
    a :class:`Record`; with one, the :class:`Readings` of that record.
    A record's tensors may lie on the host: each is moved to ``key``'s
    device as it is read."""
    dev = key.device
    k_init, k_res, k_prop = filter_keys(key, n_steps)
    xs, lw = model.init(k_init, n, dtype)
    log_n = math.log(n)
    log_z = torch.zeros((), dtype=dtype, device=dev)
    out = Record() if follow is None else None
    rd = None if follow is None else Readings(model.discrete)
    if follow is not None and (follow.broken or follow.log_zs is None
                               or follow.log_zs.shape != (n_steps,)):
        rd.fail()
        return rd
    log_zs = []
    for t in range(n_steps):
        lse = _lse(lw, dtype)
        ess = torch.exp(2.0 * lse - _lse(2.0 * lw.to(dtype), dtype))
        ratio = float(ess) / n
        own = ratio < threshold
        if follow is not None:
            theirs = t in follow.events
            if own != theirs and abs(ratio - threshold) > DECISION_BAND:
                rd.put("state_gap", math.inf)     # another schedule
            own = theirs
        if own:
            if follow is None:
                cc = systematic_counts(k_res[t], lw, n, dtype)
                post = expand(xs, cc)
                out.events[t] = (lw, xs, post)
            else:
                lw_p, xs_p, post = (v.to(dev) for v in follow.events[t])
                rd.states(xs_p, xs, lw_p, lw)
                own_cc = systematic_counts(k_res[t], lw_p.to(dtype), n)
                rd.put("counts_gap", offspring_gap(xs_p, post, own_cc))
                if post.shape != (n,):
                    break
            xs = post.to(xs.dtype)
            log_z = log_z + lse - log_n
            lw = torch.zeros_like(lw)
        xs, incr = model.step(k_prop[t], t, xs, dtype)
        lw = lw + incr
        log_zs.append(log_z + _lse(lw, dtype) - log_n)
    log_zs = torch.stack(log_zs) if len(log_zs) == n_steps else None
    if follow is None:
        out.final = (xs, lw)
        out.log_zs = log_zs
        return out
    if log_zs is None:
        rd.fail()
        return rd
    if follow.final is None or len(follow.final) != 2:
        rd.put("state_gap", math.inf)
    else:
        xs_f, lw_f = (v.to(dev) for v in follow.final)
        rd.states(xs_f, xs, lw_f, lw)
    gaps = (follow.log_zs.to(dev).to(torch.float64)
            - log_zs.to(torch.float64)).abs()
    gap = float(gaps.max())
    rd.put("log_z_gap", gap if math.isfinite(gap) else math.inf)
    return rd
