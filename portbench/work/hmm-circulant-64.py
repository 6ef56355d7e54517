"""Work counts of ``hmm-circulant-64``'s calls, from shapes alone: what
the problem needs whatever implements it. Each input byte is read once
and each output byte written once.

- The bootstrap filter: as ``tracking-1d``'s filter, a step reads and
  writes each particle's state and log-weight (a 4-byte state index),
  16 bytes a particle; a resampling 8 for the counts and 8 for the
  gather.
"""

from portbench.lib import peaks

STEP_BYTES = 16
COUNTS_BYTES = 8
GATHER_BYTES = 8


def cdf_counts_least_s(n: int) -> float:
    return peaks.least_s(bytes_=COUNTS_BYTES * n)


def call_least_s(n: int, steps: int, resamples: float) -> float:
    return peaks.least_s(bytes_=n * (STEP_BYTES * steps + (
        COUNTS_BYTES + GATHER_BYTES) * resamples))
