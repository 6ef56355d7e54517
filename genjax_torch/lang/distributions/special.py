"""Special functions the distribution tail needs and torch lacks: the
principal-branch Lambert W (Halley iteration), the log of the modified
Bessel function of the first kind for general order (series + uniform
asymptotic expansion), and the Gauss hypergeometric function 2F1
(counterpart of ``genjax_tpu/lang/distributions/special.py`` and of
``jax.scipy.special.hyp2f1``, which the beta-quotient density calls).

Every function is elementwise and broadcasts. The JAX package's fixed
loops are Python loops of the same length here; its per-element
``while_loop``s (the 2F1 series) are masked loops over the whole tensor
that stop once no element is active, each element keeping its value
from the trip its own loop would have ended on.
"""

from __future__ import annotations

import math

import torch

__all__ = ["lambertw", "log_bessel_iv", "hyp2f1"]

_EPS32 = float(torch.finfo(torch.float32).eps)


def _f(x, like=None) -> torch.Tensor:
    dev = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def lambertw(x, iters: int = 20) -> torch.Tensor:
    """Principal branch W0 for x >= -1/e, by Halley's method (a fixed
    number of iterations)."""
    x = _f(x)
    lx = torch.log(torch.clamp(x, min=1e-30))
    w = torch.where(x > math.e, lx - torch.log(torch.clamp(lx, min=1e-30)),
                    x / (1.0 + x * (1.0 + x)))
    w = torch.where(x == 0.0, torch.zeros_like(w), w)
    for _ in range(iters):
        ew = torch.exp(w)
        f = w * ew - x
        w1 = w + 1.0
        w = w - f / (ew * w1 - (w + 2.0) * f / (2.0 * w1))
    return w


def _log_iv_series(v, x, terms: int = 40):
    """log I_v(x) by the ascending series; ``x`` carries a trailing axis
    of length 1 that the terms fill."""
    k = torch.arange(terms, dtype=torch.float32, device=x.device)
    log_terms = ((2.0 * k + v) * torch.log(x / 2.0)
                 - torch.lgamma(k + 1.0) - torch.lgamma(k + v + 1.0))
    return torch.logsumexp(log_terms, dim=-1)


def _log_iv_uniform_asymptotic(v, x):
    """Uniform asymptotic expansion for large order and argument
    (Abramowitz & Stegun 9.7.7, leading terms)."""
    z = x / torch.clamp(v, min=1e-10)
    t = 1.0 / torch.sqrt(1.0 + z * z)
    eta = torch.sqrt(1.0 + z * z) + torch.log(z / (1.0 + torch.sqrt(1.0 + z * z)))
    u1 = (3.0 * t - 5.0 * t ** 3) / 24.0
    series = 1.0 + u1 / torch.clamp(v, min=1e-10)
    return (v * eta - 0.5 * torch.log(2.0 * math.pi * v) + 0.5 * torch.log(t)
            + torch.log(torch.clamp(series, min=1e-30)))


def log_bessel_iv(v, x) -> torch.Tensor:
    """log I_v(x) for v >= 0, x > 0: the series for small x, the uniform
    asymptotic expansion for large (v, x), ``log i0e(x) + x`` for small
    orders."""
    x = _f(x)
    v = _f(v, x).to(x.device)
    small = _log_iv_series(v[..., None], x[..., None])
    large = torch.where(
        v > 0.5, _log_iv_uniform_asymptotic(torch.clamp(v, min=0.51), x),
        torch.log(torch.special.i0e(x)) + x)
    use_series = (x < 20.0) & (x < 2.0 * (v + 10.0))
    return torch.where(use_series, small, large)


# -- 2F1 -------------------------------------------------------------------


def _gammasgn(x):
    floor_x = torch.floor(x)
    neg = x < 0
    one = torch.ones_like(x)
    out = torch.where((neg & (floor_x % 2 != 0)) | ((x == 0) & torch.signbit(x)),
                      -one, one)
    return torch.where(neg & (floor_x == x), torch.full_like(x, math.nan), out)


def _gamma(x):
    return _gammasgn(x) * torch.exp(torch.lgamma(x))


def _masked_loop(cond, body, state, limit: int):
    """Run ``body`` on the elements where ``cond(state)`` holds, until it
    holds nowhere or ``limit`` trips have run. ``state`` is a dict of
    tensors of one shape; an inactive element keeps its values."""
    for _ in range(limit):
        on = cond(state)
        if not bool(on.any()):
            break
        new = body(dict(state))
        state = {k: torch.where(on, new[k], state[k]) for k in state}
    return state


def _hyp2f1_serie(a, b, c, x):
    """The Taylor series, term by term until the term drops below f32
    epsilon relative to the sum (250 terms at most)."""
    z = torch.zeros_like(x)
    state = {"serie": z, "k": z + 1.0, "term": z + 1.0}

    def cond(s):
        return (s["k"] < 250) & (s["term"].abs() > _EPS32 * s["serie"].abs())

    def body(s):
        k = s["k"]
        return {"serie": s["serie"] + s["term"],
                "term": s["term"] * ((a + k - 1) * (b + k - 1) / (c + k - 1)
                                     / k * x),
                "k": k + 1}

    return _masked_loop(cond, body, state, 250)["serie"]


def _hyp2f1_terminal(a, b, c, x, on):
    """The series that terminates where ``a`` or ``b`` is a non-positive
    integer, run to ``|a|`` terms on the elements ``on`` (the others'
    values are not used)."""
    eps = _EPS32 * 50
    ib = torch.round(b)
    mask = (b < a) & ((b - ib).abs() < eps) & ~((c % 1 == 0) & (c <= 0)
                                                & (c > b))
    a, b = torch.where(mask, b, a), torch.where(mask, a, b)
    a = a.abs()
    z = torch.zeros_like(x)
    state = {"serie": z + 1.0, "term": z + 1.0, "i": z + 1.0}

    def cond(s):
        return on & (s["i"] < a + 1)

    def body(s):
        i = s["i"]
        term = s["term"] * (-(a - i + 1) / (c + i - 1) * (b + i - 1) / i * x)
        return {"serie": s["serie"] + term, "term": term, "i": i + 1}

    live = torch.where(on, a, torch.zeros_like(a))
    limit = int(live.max().item()) + 1 if a.numel() else 0
    return _masked_loop(cond, body, state, limit)["serie"]


def _hyp2f1_digamma_transform(a, b, c, x, on):
    """AMS55 15.3.10-12, for ``x`` near 1 with ``c - a - b`` an
    integer, on the elements ``on``."""
    d = c - a - b
    s = 1 - x
    rd = torch.round(d)
    zero = torch.zeros_like(d)
    e = torch.where(rd >= 0, d, -d)
    d1 = torch.where(rd >= 0, d, zero)
    d2 = torch.where(rd >= 0, zero, d)
    ard = torch.where(rd >= 0, rd, -rd)
    ax = torch.log(s)
    one = torch.ones_like(x)
    y = (torch.digamma(one) + torch.digamma(1.0 + e) - torch.digamma(a + d1)
         - torch.digamma(b + d1) - ax)
    y = y / _gamma(e + 1.0)
    p = (a + d1) * (b + d1) * s / _gamma(e + 2.0)
    state = {"p": p, "q": y, "t": one, "y": y}

    def cond(st):
        return on & (st["t"] < 250) & (st["q"].abs()
                                       >= _EPS32 * st["y"].abs())

    def body(st):
        t, p = st["t"], st["p"]
        r = (torch.digamma(1.0 + t) + torch.digamma(1.0 + t + e)
             - torch.digamma(a + t + d1) - torch.digamma(b + t + d1) - ax)
        q = p * r
        p = p * (s * (a + t + d1) / (t + 1.0))
        p = p * ((b + t + d1) / (t + 1.0 + e))
        return {"p": p, "q": q, "t": t + 1.0, "y": st["y"] + q}

    y = _masked_loop(cond, body, state, 250)["y"]

    # compute_sum: a loop of ard - 1 trips per element.
    st = {"p": one.clone(), "t": torch.zeros_like(x), "y1": one.clone(),
          "i": one.clone()}

    def cond2(st):
        return on & (st["i"] < ard)

    def body2(st):
        t = st["t"]
        r = 1.0 - e + t
        p = st["p"] * (s * (a + t + d2) * (b + t + d2) / r)
        t = t + 1.0
        p = p / t
        return {"p": p, "t": t, "y1": st["y1"] + p, "i": st["i"] + 1}

    live = torch.where(on, ard, torch.zeros_like(ard))
    limit = int(live.max().item()) + 1 if ard.numel() else 0
    y1 = _masked_loop(cond2, body2, st, limit)["y1"]
    pc = _gamma(c)
    y1 = y1 * (_gamma(e) * pc / (_gamma(a + d1) * _gamma(b + d1)))
    ys = y * (pc / (_gamma(a + d2) * _gamma(b + d2)))
    odd = torch.nan_to_num(ard, nan=0.0).to(torch.int64) % 2 != 0
    ys = torch.where(odd, -ys, ys)
    q = s ** rd
    summed = torch.where(rd > 0, ys * q + y1, ys + y1 * q)
    return torch.where(rd == 0, y * _gamma(c) / (_gamma(a) * _gamma(b)),
                       summed)


def _hyp2f1_terminal_or_serie(a, b, c, x):
    eps = _EPS32 * 50
    d = c - a - b
    ia, ib, id_ = torch.round(a), torch.round(b), torch.round(d)
    neg_int_a = (a <= 0) & ((a - ia).abs() < eps)
    neg_int_b = (b <= 0) & ((b - ib).abs() < eps)
    neg_int = neg_int_a | neg_int_b
    out = _hyp2f1_serie(a, b, c, x)
    if bool(neg_int.any()):
        out = torch.where(neg_int, _hyp2f1_terminal(a, b, c, x, neg_int), out)
    digamma_case = (x > 0.9) & ~neg_int & ((d - id_).abs() < eps)
    if bool(digamma_case.any()):
        out = torch.where(digamma_case, _hyp2f1_digamma_transform(a, b, c, x,
                                                                digamma_case),
                          out)
    return out


def hyp2f1(a, b, c, x) -> torch.Tensor:
    """The Gauss hypergeometric function 2F1(a, b; c; x) for real
    arguments, by ``jax.scipy.special.hyp2f1``'s case analysis (Pearson,
    Olver & Porter 2014): the Taylor series, its terminating form, the
    Euler transform for ``c - a - b <= -1``, the closed forms at
    ``b = c``, ``a = c`` and ``x = 1``, and the digamma transform near
    ``x = 1``; ``inf`` for ``x > 1``."""
    x = _f(x)
    a, b, c = (_f(v, x).to(x.device) for v in (a, b, c))
    a, b, c, x = torch.broadcast_tensors(a, b, c, x)
    eps = _EPS32 * 50
    d = c - a - b
    s = 1 - x
    ca, cb = c - a, c - b
    id_ = torch.round(d)
    index = torch.full(x.shape, 6, dtype=torch.int64, device=x.device)
    index = torch.where(x == 1, torch.full_like(index, 5), index)
    index = torch.where(x > 1, torch.ones_like(index), index)
    index = torch.where((x < 1) & (a == c), torch.full_like(index, 4), index)
    index = torch.where((x < 1) & (b == c), torch.full_like(index, 3), index)
    index = torch.where((d <= 0) & (x == 1), torch.ones_like(index), index)
    index = torch.where((d <= -1) & ~(((d - id_).abs() >= eps) & (s < 0)),
                        torch.full_like(index, 2), index)
    index = torch.where((c == 0) | ((c < 0) & (c % 1 == 0)),
                        torch.ones_like(index), index)
    index = torch.where((x == 0) | (((a == 0) | (b == 0)) & (c != 0)),
                        torch.zeros_like(index), index)
    out = torch.where(index == 0, torch.ones_like(x),
                      torch.full_like(x, math.inf))
    if bool((index == 2).any()):
        out = torch.where(index == 2,
                          s ** d * _hyp2f1_terminal_or_serie(ca, cb, c, x), out)
    out = torch.where(index == 3, s ** (-a), out)
    out = torch.where(index == 4, s ** (-b), out)
    out = torch.where(index == 5, _gamma(c) * _gamma(d)
                      / (_gamma(ca) * _gamma(cb)), out)
    if bool((index == 6).any()):
        out = torch.where(index == 6, _hyp2f1_terminal_or_serie(a, b, c, x),
                          out)
    return out
