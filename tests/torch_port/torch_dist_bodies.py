"""Rank bodies of the port's distributed tests. Each runs on every rank of
a gloo world (``torch_dist_world.World.run``): it takes the global inputs
as numpy arrays, works on its rank's slice through
``genjax_torch.parallel`` and returns picklable results (its slice of a
sharded output, the replicated values, and what ``parallel.comm``
counted). Nothing here imports JAX."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

_MESHES: dict = {}


def _mesh(names=("particles",), shape=None):
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(shape or (dist.get_world_size(),))
    key = (shape, tuple(names))
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh("cpu", shape,
                                        mesh_dim_names=tuple(names))
    return _MESHES[key]


def _np(x):
    return x.detach().cpu().numpy()


def _key(data):
    from genjax_torch.interop import key_from_numpy

    return key_from_numpy(data)


def _local(x, mesh, axis="particles"):
    from genjax_torch.parallel import shard_leading_axis

    return shard_leading_axis(torch.as_tensor(np.asarray(x)), mesh, axis)


def _reset():
    from genjax_torch.parallel import comm

    comm.reset()


def _comm() -> dict:
    from genjax_torch.parallel import comm

    return {"by_op": comm.by_op(), "max_elements": comm.max_elements(),
            "ring_trips": comm.ring_trips, "host_syncs": comm.host_syncs}


# -- collectives ------------------------------------------------------------


def blocked(lw, block=256):
    from genjax_torch.parallel import blocked_ess, blocked_logz, blocked_stats

    m = _mesh()
    x = _local(lw, m)
    _reset()
    logz, ess = blocked_stats(x, m, block=block)
    comm = _comm()
    return {"logz": float(logz), "ess": float(ess), "comm": comm,
            "logz1": float(blocked_logz(x, m, block=block)),
            "ess1": float(blocked_ess(x, m, block=block))}


def shardmap_stats(lw):
    from genjax_torch.parallel import shardmap_ess, shardmap_logz

    m = _mesh()
    x = _local(lw, m)
    return {"logz": float(shardmap_logz(x, m)),
            "ess": float(shardmap_ess(x, m))}


def ring_step(key, lw, leaves, halo=None, block=256):
    from genjax_torch.parallel import ring_resample_step

    m = _mesh()
    tree = tuple(_local(v, m) for v in leaves)
    _reset()
    out, logz, ess = ring_resample_step(_key(key), _local(lw, m), tree, m,
                                        halo=halo, block=block)
    return {"out": [_np(o) for o in out], "logz": float(logz),
            "ess": float(ess), "comm": _comm()}


def ring_resample(key, lw, leaves, halo=None):
    from genjax_torch.parallel import ring_systematic_resample

    m = _mesh()
    tree = tuple(_local(v, m) for v in leaves)
    out = ring_systematic_resample(_key(key), _local(lw, m), tree, m,
                                   halo=halo)
    return [_np(o) for o in out]


def shardmap_resample(key, lw, leaves):
    from genjax_torch.parallel import shardmap_systematic_resample

    m = _mesh()
    tree = tuple(_local(v, m) for v in leaves)
    _reset()
    out = shardmap_systematic_resample(_key(key), _local(lw, m), tree, m)
    return {"out": [_np(o) for o in out], "comm": _comm()}


def blocked_error(n):
    """The error a blocked reduction of ``n`` weights raises here."""
    from genjax_torch.parallel import blocked_stats

    m = _mesh()
    per = n // dist.get_world_size()
    try:
        blocked_stats(torch.zeros(per), m)
    except ValueError as e:
        return str(e)
    return None


def gather_and_check(x):
    from genjax_torch.parallel import gather_leading_axis, replicated

    m = _mesh()
    full = gather_leading_axis(_local(x, m), m)
    replicated(full, m)
    try:
        replicated(torch.tensor(float(dist.get_rank())), m)
        differs = None
    except ValueError as e:
        differs = str(e)
    return _np(full), differs


def replicated_check(values):
    """``replicated`` on rank r's leaf ``values[r]``: None where it
    passes, the error text where it raises."""
    from genjax_torch.parallel import replicated

    try:
        replicated(torch.tensor(values[dist.get_rank()]), _mesh())
    except ValueError as e:
        return str(e)
    return None


# -- SMC and the particle filter ---------------------------------------------


def _beta_bernoulli_target():
    import genjax_torch as g
    from genjax_torch.inference import Target

    @g.gen
    def bb(a, b):
        p = g.beta(a, b) @ "p"
        v = g.flip(p) @ "v"
        return v

    return Target(bb, (2.0, 2.0), g.C["v"].set(True))


def smc_step(key, k, ess_threshold=0.5, impl="collective", mesh_2d=False):
    from genjax_torch.parallel import sharded_smc_step

    if mesh_2d:
        m, axis = _mesh(("hosts", "chips"), (2, 2)), ("hosts", "chips")
    else:
        m, axis = _mesh(), "particles"
    step = sharded_smc_step(_beta_bernoulli_target(), k, m, axis,
                            ess_threshold=ess_threshold, impl=impl)
    _reset()
    col, logz = step(_key(key))
    return {"p": _np(col.get_particles().get_choices()["p"]),
            "lw": _np(col.get_log_weights()), "logz": float(logz),
            "comm": _comm()}


def importance_weights(key, k):
    from genjax_torch.parallel import blocked_logz, sharded_importance

    m = _mesh()
    col = sharded_importance(_beta_bernoulli_target(), k, m)(_key(key))
    return _np(col.get_log_weights()), float(blocked_logz(
        col.get_log_weights(), m))


def resample_collection(key, res_key, k, impl):
    from genjax_torch.parallel import (
        blocked_ess,
        blocked_logz,
        sharded_importance,
        sharded_resample,
    )

    m = _mesh()
    col = sharded_importance(_beta_bernoulli_target(), k, m)(_key(key))
    out = sharded_resample(col, _key(res_key), m, impl=impl)
    return {"logz_in": float(blocked_logz(col.get_log_weights(), m)),
            "logz_out": float(blocked_logz(out.get_log_weights(), m)),
            "ess_out": float(blocked_ess(out.get_log_weights(), m)),
            "p": _np(out.get_particles().get_choices()["p"])}


def _pf_model():
    from genjax_torch.core import random

    def init(keys):
        return random.normal(keys), torch.zeros(())

    def step(keys, x, y):
        x_new = 0.9 * x + 0.3 * random.normal(keys)
        return x_new, torch.distributions.Normal(x_new, 0.5).log_prob(y)

    return init, step


def particle_filter(key, ys, n, use_collectives=True):
    from genjax_torch.parallel import sharded_particle_filter

    init, step = _pf_model()
    pf = sharded_particle_filter(init, step, n, _mesh(),
                                 use_collectives=use_collectives)
    _reset()
    final, log_zs = pf(_key(key), torch.tensor(np.asarray(ys)))
    return {"particles": _np(final.particles), "lw": _np(final.log_weights),
            "log_z": float(final.log_z), "log_zs": _np(log_zs),
            "comm": _comm()}


def batched_filter_error():
    from genjax_torch.parallel import sharded_particle_filter

    init, step = _pf_model()
    try:
        sharded_particle_filter(init, step, 64, _mesh(), batched=True)
    except ValueError as e:
        return str(e)
    return None


# -- entry points on the CPU --------------------------------------------------


def entry_pf(key, n, steps, model, use_collectives):
    from genjax_torch import entry as E

    run, _ = E.build_sharded_pf(n, steps, model=model,
                                use_collectives=use_collectives,
                                device="cpu")
    _reset()
    return float(run(_key(key))), _comm()


def entry_sir(key, k):
    from genjax_torch import entry as E

    run, _ = E.build_sharded_sir(k, device="cpu")
    mean, logz = run(_key(key))
    return float(mean), float(logz)


def entry_hmm(key, s, t, block):
    from genjax_torch import entry as E

    run, _ = E.build_time_sharded_hmm(s, t, block=block, device="cpu")
    alphas, lz, z = run(_key(key))
    return _np(alphas), float(lz), _np(z)


def entry_svgd(key, n, steps, b, d):
    from genjax_torch import entry as E

    run, _, _ = E.build_sharded_svgd(n, steps, b, d, device="cpu")
    return _np(run(_key(key)))


def entry_nuts(key, chains, warm, samples):
    from genjax_torch import entry as E

    mesh = _mesh(("chains",))
    run, _ = E.build_nuts_regression(chains, warm, samples, max_depth=4,
                                     device="cpu", mesh=mesh)
    chms, _ = run(_key(key))
    return _np(chms["slope"]), _np(chms["icept"])


# -- sequence parallelism ----------------------------------------------------


def _hmm_config(prior, trans, obs):
    from genjax_torch.interop import hmm_config_from_numpy

    return hmm_config_from_numpy(prior, trans, obs)


def seq_filter(prior, trans, obs_logits, obs, block):
    from genjax_torch.parallel import time_sharded_filter

    m = _mesh(("time",))
    _reset()
    alphas, lz = time_sharded_filter(_hmm_config(prior, trans, obs_logits),
                                     _local(obs, m, "time"), m, "time", block)
    return _np(alphas), float(lz), _comm()


def seq_ffbs(key, prior, trans, obs_logits, obs, block):
    from genjax_torch.parallel import (
        time_sharded_backward_sample,
        time_sharded_filter,
    )

    m = _mesh(("time",))
    config = _hmm_config(prior, trans, obs_logits)
    alphas, _ = time_sharded_filter(config, _local(obs, m, "time"), m,
                                    "time", block)
    _reset()
    z = time_sharded_backward_sample(_key(key), config, alphas, m, "time",
                                     block)
    return _np(z), _comm()


def seq_error(prior, trans, obs_logits, obs, block):
    from genjax_torch.parallel import time_sharded_filter

    m = _mesh(("time",))
    try:
        time_sharded_filter(_hmm_config(prior, trans, obs_logits),
                            _local(obs, m, "time"), m, "time", block)
    except ValueError as e:
        return str(e)
    return None


# -- chain-sharded MCMC ------------------------------------------------------


def cross_chain(zs, acc, with_mesh=True):
    from genjax_torch.inference.adaptation import _cross_chain_stats

    m = _mesh(("chains",)) if with_mesh else None
    z, a = torch.tensor(np.asarray(zs)), torch.tensor(np.asarray(acc))
    if m is not None:
        z, a = _local(zs, m, "chains"), _local(acc, m, "chains")
    _reset()
    out = _cross_chain_stats(z, a, m, "chains")
    return [_np(x) for x in out], _comm()


def _quartic(z):
    return -0.5 * (z ** 2).sum(-1) - 0.1 * (z ** 4).sum(-1)


def warmup(z0, key, num_warmup, max_depth):
    from genjax_torch.inference import warmup_chains

    m = _mesh(("chains",))
    _reset()
    z, eps, inv_mass = warmup_chains(_quartic, _local(z0, m, "chains"),
                                     _key(key), num_warmup=num_warmup,
                                     max_depth=max_depth, mesh=m)
    return _np(z), _np(eps), _np(inv_mass), _comm()


def _nuts_models():
    import genjax_torch as g

    @g.gen
    def normal_model():
        mu = g.normal(0.0, 1.0) @ "mu"
        tau = g.normal(0.0, 1.0) @ "tau"
        _ = g.normal(mu, torch.exp(tau)) @ "y"

    @g.gen
    def gamma_model():
        mu = g.normal(0.0, 1.0) @ "mu"
        sig = g.gamma(2.0, 2.0) @ "sig"
        _ = g.normal(mu, sig) @ "y"

    return {"normal": (normal_model, ("mu", "tau")),
            "gamma": (gamma_model, ("mu", "sig"))}


def nuts(key, model, n_chains, num_warmup, num_samples, max_depth,
         transforms=None, with_mesh=True):
    import genjax_torch as g
    from genjax_torch.inference import Target, run_nuts

    gf, sites = _nuts_models()[model]
    target = Target(gf, (), g.C["y"].set(1.0))
    m = _mesh(("chains",)) if with_mesh else None
    chms, _ = run_nuts(target, _key(key), n_chains=n_chains,
                       num_warmup=num_warmup, num_samples=num_samples,
                       max_depth=max_depth, mesh=m, transforms=transforms)
    return [_np(chms[s]) for s in sites]


def hmc_chains(key, n_chains, n_steps):
    """Independent HMC chains on this rank's slice, each on the keys of its
    global index: no coupling, so no collective."""
    import genjax_torch as g
    from genjax_torch.core import random
    from genjax_torch.inference import mh
    from genjax_torch.inference.requests import HMC
    from genjax_torch.parallel.mesh import mesh_axis

    gf, _ = _nuts_models()["normal"]
    ax = mesh_axis(_mesh(("chains",)), "chains")
    per = n_chains // ax.size
    chains = torch.arange(ax.rank * per, (ax.rank + 1) * per)
    keys = random.fold_in(_key(key)[None], chains)
    tr, _ = gf.generate(keys, g.C["y"].set(torch.ones(per)), ())
    mus = []
    for i in range(n_steps):
        tr, _ = mh(random.fold_in(keys, i), tr,
                   HMC(g.S.at["mu"] | g.S.at["tau"], 0.05, 5))
        mus.append(tr.get_choices()["mu"])
    return _np(torch.stack(mus, 1))


# -- SVGD ----------------------------------------------------------------------


SCALES = (1.0, 2.0, 0.5, 1.5)


def _svgd_logp(z):
    return -0.5 * ((z / torch.tensor(SCALES)) ** 2).sum(-1)


def svgd_step(xs, step_size):
    from genjax_torch.parallel import sharded_svgd_step

    m = _mesh()
    _reset()
    out = sharded_svgd_step(_svgd_logp, _local(xs, m), step_size, m)
    return _np(out), _comm()


def svgd_run(xs, n_steps, step_size):
    from genjax_torch.parallel import run_sharded_svgd

    m = _mesh()
    return _np(run_sharded_svgd(_svgd_logp, _local(xs, m), n_steps,
                                step_size, m))


# -- sharded SMC², parallel tempering and particle Gibbs -----------------------


def smc2_run(key, ys, n_theta, n_x, proposal, ess_threshold, sharded=True):
    """Config 7's model on the JAX test's data: this rank's θ-rows of
    ``sharded_smc2`` (or, with ``sharded=False``, the whole unsharded
    ``smc2`` run), with what ``parallel.comm`` counted."""
    from genjax_torch.entry import smc2_model
    from genjax_torch.inference.smc2 import smc2
    from genjax_torch.parallel import sharded_smc2

    ys = torch.as_tensor(np.asarray(ys))
    _reset()
    if sharded:
        res = sharded_smc2(*smc2_model(), n_theta=n_theta, n_x=n_x,
                           mesh=_mesh(), proposal=proposal,
                           ess_threshold=ess_threshold)(_key(key), ys)
    else:
        res = smc2(*smc2_model(), n_theta=n_theta, n_x=n_x,
                   proposal=proposal, ess_threshold=ess_threshold)(
            _key(key), ys)
    return {"thetas": _np(res.thetas), "log_weights": _np(res.log_weights),
            "log_z": _np(res.log_z), "ess_history": _np(res.ess_history),
            "rejuv_accept": _np(res.rejuv_accept),
            "n_rejuvenations": res.n_rejuvenations, "comm": _comm()}


def _conjugate_pt():
    import genjax_torch as g
    from genjax_torch.inference import Target
    from genjax_torch.inference.requests import Rejuvenate

    @g.gen
    def conjugate_normal(obs_std):
        mu = g.normal(0.0, 1.0) @ "mu"
        return g.normal(mu, obs_std) @ "y"

    def drift_request():
        @g.gen
        def drift(old):
            return g.normal(old["mu"], 0.4) @ "mu"

        return Rejuvenate(drift)

    return (Target(conjugate_normal, (0.5,), g.C["y"].set(1.0)),
            drift_request)


def pt_run(key, n_rungs, n_steps, n_ladders, burn_in, sharded=True):
    """The JAX test's parallel tempering (ladders of ``n_rungs`` from 0 to
    1, the drift move) on ``n_ladders`` ladders, keys ``split(key,
    n_ladders)``: this rank's rungs of ``sharded_parallel_tempering``, or
    the unsharded run."""
    from genjax_torch.core import random
    from genjax_torch.inference.pt import parallel_tempering
    from genjax_torch.parallel import sharded_parallel_tempering

    target, drift = _conjugate_pt()
    betas = torch.linspace(0.0, 1.0, n_rungs)
    if sharded:
        run = sharded_parallel_tempering(target, betas, _mesh(),
                                         make_request=drift)
    else:
        run = parallel_tempering(target, betas, make_request=drift)
    _reset()
    res = run(random.split(_key(key), n_ladders), n_steps, burn_in=burn_in,
              collect=lambda tr: tr.get_choices()["mu"])
    return {"samples": _np(res.samples), "swap_rate": _np(res.swap_rate),
            "accept_rate": _np(res.accept_rate),
            "mu": _np(res.traces.get_choices()["mu"]),
            "score": _np(res.traces.get_score()), "comm": _comm()}


def _pgibbs_model(a, q, r):
    import math

    from genjax_torch.core import random
    from genjax_torch.lang.distributions import normal

    sig1, sq, sr = math.sqrt(a * a + q), math.sqrt(q), math.sqrt(r)

    def init(keys, n):
        return sig1 * random.normal(keys, (n,))

    def prop(keys, xs):
        return a * xs + sq * random.normal(keys, xs.shape[keys.ndim - 1:])

    def ll(xs, y):
        return normal.logpdf(y, xs, sr)

    def tl(xp, xn):
        return normal.logpdf(xn, a * xp, sq)

    return init, prop, ll, tl


def pgibbs_run(key, ys, a, q, r, n_particles, n_iters, n_chains,
               sharded=True, burn_in=0):
    """The JAX test's PGAS chains: this rank's chains of
    ``sharded_particle_gibbs`` with the pooled per-chain means, or the
    unsharded run on ``split(key, n_chains)``."""
    from genjax_torch.core import random
    from genjax_torch.inference.pgibbs import particle_gibbs
    from genjax_torch.parallel import (
        pooled_chain_means,
        sharded_particle_gibbs,
    )

    init, prop, ll, tl = _pgibbs_model(a, q, r)
    ys = torch.as_tensor(np.asarray(ys))
    if not sharded:
        res = particle_gibbs(init, prop, ll, n_particles, n_iters,
                             trans_logpdf=tl)(
            random.split(_key(key), n_chains), ys)
        return {"paths": _np(res.paths)}
    m = _mesh()
    res = sharded_particle_gibbs(init, prop, ll, n_particles, n_iters,
                                 n_chains, m, trans_logpdf=tl)(_key(key), ys)
    return {"paths": _np(res.paths),
            "means": _np(pooled_chain_means(res.paths, m, burn_in=burn_in))}


# -- checkpoints and elastic recovery ------------------------------------------


def _elastic_step(key, n):
    """A per-particle step on this rank's rows of ``n``: every particle's
    draw from ``fold_in(fold_in(key, i), particle)``, so the result does
    not depend on the layout; a NaN at global step 13 while ``poison``."""
    from genjax_torch.core import random
    from genjax_torch.parallel.mesh import rank_range

    lo, hi = rank_range(n, _mesh(), "particles")
    rows = torch.arange(lo, hi)

    def step(i, st):
        eps = random.normal(random.fold_in(random.fold_in(key, i)[None],
                                           rows))
        xs = 0.9 * st["xs"] + 0.1 * eps
        lw = st["lw"] - 0.5 * xs * xs
        bad = (i == 13) & (st["poison"] != 0.0)
        return {"xs": xs + torch.where(bad, torch.nan, 0.0), "lw": lw,
                "t": st["t"] + 1.0, "poison": st["poison"]}

    return step, lo, hi


def elastic_dcp(key, xs0, ckpt_dir, n_steps, poison, restore_at=None):
    """``run_elastic`` over this rank's rows with a DCP checkpoint every
    2 chunks of 4 in ``ckpt_dir``; a NaN at step 13 while ``poison``,
    cleared by ``place`` on recovery. With ``restore_at``, the state is
    first restored from ``ckpt_dir`` (saved by another world) and the
    run goes on from that step. Returns this rank's final rows, the
    events and the restored step."""
    from genjax_torch.utils import restore_checkpoint, run_elastic

    m = _mesh()
    step, lo, hi = _elastic_step(_key(key), len(xs0))
    state = {"xs": torch.as_tensor(np.asarray(xs0))[lo:hi],
             "lw": torch.zeros(hi - lo), "t": torch.zeros(()),
             "poison": torch.tensor(float(poison))}
    start = 0
    if restore_at is not None:
        state = restore_checkpoint(ckpt_dir, state, m)
        state["poison"] = torch.zeros(())
        start = restore_at
        ckpt_dir = ckpt_dir + "_resumed"

    def place(st, devs):
        return {**st, "poison": torch.zeros(())}

    res = run_elastic(lambda i, s: step(start + i, s), state,
                      n_steps - start, ckpt_path=ckpt_dir, chunk=4,
                      checkpoint_every=2, max_retries=2, place=place)
    return {"state": {k: _np(v) for k, v in res.state.items()},
            "events": [(e.kind, e.step, e.resumed_from, e.n_devices)
                       for e in res.events]}
