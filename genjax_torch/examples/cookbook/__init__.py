"""The JAX package's cookbook (``docs/cookbook/NN_*.py``), ported as
``cbNN_<name>.py``; see :mod:`genjax_torch.examples`."""
