"""Shared reading of the profiled calls' device events by kernel: each
of the port's kernels is known by its CUDA functions' bare names
(``genjax_torch/csrc/*.cu``)."""

KERNELS = {
    "fused_step": ("step",),
    "cdf_counts": ("tile_partials", "emit"),
}


def events(ctx, kernel: str) -> dict:
    """``{function: [durations in ns]}`` of the kernel's device events in
    the profiled calls; None where no profile saw the device."""
    from portbench.lib.profile import kernel_base

    if ctx.profile is None or not ctx.profile.events:
        return None
    names = KERNELS[kernel]
    out = {n: [] for n in names}
    for name, _, d in ctx.profile.events:
        base = kernel_base(name)
        if base in out:
            out[base].append(d)
    return out


def launches(ev: dict):
    """Launches seen, where every function of the kernel shows the same
    count (else the profile lost events: None)."""
    counts = {len(v) for v in ev.values()}
    if len(counts) != 1:
        return None
    n = counts.pop()
    return n or None
