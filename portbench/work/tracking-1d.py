"""Work counts of ``tracking-1d``'s filter calls, from shapes alone:
what the work needs whatever implements it. Each input byte is read
once and each output byte written once; a kernel's own re-reads and
scratch do not count.

- A filter step (the fused step): read the state and the log-weight,
  write both: 16 bytes a particle in float32.
- A resampling: the CDF pass reads the log-weights and writes the
  counts (8 bytes a particle); the gather reads and writes the state
  (8 bytes a particle).
"""

from portbench.lib import peaks

#: Bytes a particle of one filter step.
STEP_BYTES = 16
#: Bytes a particle of the CDF-to-counts pass.
COUNTS_BYTES = 8
#: Bytes a particle of the resampling's gather.
GATHER_BYTES = 8


def fused_step_least_s(n: int) -> float:
    return peaks.least_s(bytes_=STEP_BYTES * n)


def cdf_counts_least_s(n: int) -> float:
    return peaks.least_s(bytes_=COUNTS_BYTES * n)


def call_least_s(n: int, steps: int, resamples: float) -> float:
    """One filter call of ``steps`` steps with ``resamples``
    resamplings."""
    return peaks.least_s(bytes_=n * (STEP_BYTES * steps + (
        COUNTS_BYTES + GATHER_BYTES) * resamples))
