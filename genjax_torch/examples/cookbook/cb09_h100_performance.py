"""Cookbook 9 — H100 performance: how the port's fast paths work.

The JAX package's page of this number walks through the TPU's cost
model; this one walks through the card's. Every number quoted below was
measured on an NVIDIA H100 80GB HBM3 with a 700.00 W power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives it) by ``chip_smoke.py`` and is recorded in ``PERF.md`` with the
run it came from. The code runs anywhere: on the CPU each kernel
wrapper takes its plain PyTorch version, and every check below holds
there too.

## Where the time goes on the card (PERF.md §5)

1. **Host issue time.** Most paths are bound by the PyTorch ops the host
   issues, not by the card: the card sits idle 67-97 % of the time on
   every cell but the parallel HMM filter. 78-96.5 % of the ops come
   from ``core/random.py``: threefry2x32 runs on int64 words, about
   130-150 launches a key derivation (config 6: idle share 0.818, 63296
   device ops a run).
2. **Host syncs**: NUTS reads one device flag a leapfrog; the filters
   read the ESS once a step.
3. **Device time** of a few paths: the parallel exact filter and the
   batched HMM, where the log-matmul kernel runs.

## The hand-written kernels (PERF.md §6)

| kernel | what it does | card time at 2^20 | its plain version |
|---|---|---|---|
| ``csrc/cdf_counts.cu`` | systematic offspring counts: exp, prefix sum, prefix-max repair, ceil | 0.01530 ms device, 2 launches | 2.8263 ms device |
| ``csrc/fused_step.cu`` | one filter step: threefry, Box–Muller, propagate, weight, logsumexp and ESS | 0.01287 ms device, 1 launch | 0.8627 ms device |
| ``csrc/expand_adaptive.cu`` | ``repeat(leaf, counts)`` by a merge path | 0.00811 ms device (``repeat_interleave``: 0.0797) | 0.0444 ms |
| ``csrc/logmatmul.cu`` | batched log-space matrix product, TMA + ``wgmma`` in split TF32 | 16.7152 ms device at (511, 1024, 1024) | 34.8564 ms |

Three rules fall out of that record:

1. **Fuse what the host would issue op by op.** The CDF pass is about a
   hundred tiny launches as plain PyTorch; as one kernel pair it is 185
   times faster on the device.
2. **Gather by ancestor index; do not emulate.** The TPU needed a
   blocked interval expansion to avoid element gathers; on the card a
   gather by ancestor index (``searchsorted`` of the cumulative counts,
   then indexing) is the plain operation and is exact.
3. **Batch until the card notices.** A batch of keys ``B + (2,)`` runs
   ``B`` executions in one set of launches; with the host the
   bottleneck, a wider batch costs the same host time.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

import genjax_torch as g
from genjax_torch.core import random
from genjax_torch.examples import resolve_device
from genjax_torch.inference import ImportanceK, Target
from genjax_torch.ops import cdf_counts, expand_adaptive


class _CountOps(TorchDispatchMode):
    """Counts the PyTorch ops a call dispatches."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@g.gen
def bb(a, b):
    p = g.beta(a, b) @ "p"
    v = g.flip(p) @ "v"
    return v


def ancestors(counts_cum: torch.Tensor, n: int) -> torch.Tensor:
    """Destination j's source: the first i with ``counts_cum[i] > j``."""
    dest = torch.arange(n, dtype=counts_cum.dtype, device=counts_cum.device)
    return torch.searchsorted(counts_cum, dest, right=True)


def main(device=None) -> dict:
    device = resolve_device(device)
    out = {}
    # ------------------------------------------------------------------
    # Rule 2 worked example: resampling by gather by ancestor index.
    #
    # Systematic resampling needs dest[j] = src[a_j] for a monotone
    # ancestor sequence a. The CDF kernel gives each source's inclusive
    # cumulative offspring count; a searchsorted turns them into
    # ancestors and one gather moves the values. It equals the plain
    # repeat of each source by its count, bit for bit.
    # ------------------------------------------------------------------
    n = 1024
    key = random.key(0, device=device)
    logw = 2.0 * random.normal(key, (n,))
    cc = cdf_counts.systematic_cumulative(key, logw, n)
    xs = random.normal(random.key(1, device=device), (n,))
    counts = torch.diff(cc, prepend=cc.new_zeros(1))
    oracle = torch.repeat_interleave(xs, counts.long(), output_size=n)
    out["gather_equals_repeat"] = bool(torch.equal(xs[ancestors(cc, n)],
                                                   oracle))
    # Degenerate weights: one source takes almost every destination.
    heavy = torch.where(torch.arange(n, device=device) == 7, 0.0, -12.0)
    cc_h = cdf_counts.systematic_cumulative(key, heavy, n)
    counts_h = torch.diff(cc_h, prepend=cc_h.new_zeros(1))
    out["degenerate_gather_equals_repeat"] = bool(torch.equal(
        xs[ancestors(cc_h, n)],
        torch.repeat_interleave(xs, counts_h.long(), output_size=n)))
    # The expansion kernel does the same repeat by a merge path, beside
    # repeat_interleave:
    out["expand_adaptive_equals_repeat"] = bool(torch.equal(
        expand_adaptive.expand_adaptive(xs, cc, n), oracle))

    # ------------------------------------------------------------------
    # Rule 1: the CDF kernel. exp -> cumsum -> monotone repair -> ceil in
    # one kernel pair. Its contract: the last entry is exactly n, and the
    # counts never decrease (a chunked f32 cumsum can dip by an ulp; the
    # prefix-max repair is exact in floating point).
    # ------------------------------------------------------------------
    n2 = 1 << 14
    lw2 = random.normal(random.key(2, device=device), (n2,))
    cc2 = cdf_counts.systematic_cumulative(random.key(3, device=device),
                                           lw2, n2)
    out["cdf_tail"] = int(cc2[-1])
    out["cdf_monotone"] = bool((torch.diff(cc2) >= 0).all())
    assert out["cdf_tail"] == n2 and out["cdf_monotone"]

    # ------------------------------------------------------------------
    # The first bottleneck: the key layer's op count. One per-particle
    # key derivation at 2^16 particles dispatches this many PyTorch ops
    # here (on the CPU the threefry rounds run in numpy, on the card
    # each round is a handful of launches).
    # ------------------------------------------------------------------
    with _CountOps() as ops:
        keys = random.fold_in(key, torch.arange(1 << 16, device=device))
        random.normal(keys)
    out["key_derivation_ops"] = ops.n

    # ------------------------------------------------------------------
    # Rule 3 worked example: the batch axis. 256 SIR runs of 64
    # particles are one call on a batch of 256 keys.
    # ------------------------------------------------------------------
    target = Target(bb, (2.0, 2.0), g.C["v"].set(True))
    alg = ImportanceK(target, k_particles=64)
    keys = random.split(random.key(4, device=device), 256)
    posterior_means = alg.random_weighted(keys, target)[1]["p"]
    out["posterior_mean"] = float(posterior_means.mean())
    assert abs(out["posterior_mean"] - 0.6) < 0.05
    out["n2"] = n2
    return out


if __name__ == "__main__":
    r = main()
    print("gather by ancestor index == repeat:", r["gather_equals_repeat"],
          "(degenerate weights:", r["degenerate_gather_equals_repeat"], ")")
    print("expand_adaptive == repeat:", r["expand_adaptive_equals_repeat"])
    print("CDF tail pinned:", r["cdf_tail"], "monotone:", r["cdf_monotone"])
    print("ops a key derivation at 2^16:", r["key_derivation_ops"])
    print("cookbook 9 ok:", r["posterior_mean"], r["cdf_tail"], r["n2"])
