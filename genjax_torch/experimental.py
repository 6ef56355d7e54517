"""Experimental-API facade (counterpart of ``genjax_tpu/experimental.py``,
itself the mirror of the reference's empty ``genjax.experimental``).

Nothing is experimental at the moment; features graduate straight into
the stable namespaces. Kept so code importing the experimental module
ports by renaming the package only."""
