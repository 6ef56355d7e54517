"""The modeling language layer: the ``@gen`` DSL and distributions."""

from genjax_torch.lang.static import (
    AddressReuse,
    Fn,
    MissingAddress,
    StaticRequest,
    StaticTrace,
    gen,
)

__all__ = ["AddressReuse", "Fn", "MissingAddress", "StaticRequest",
           "StaticTrace", "gen"]
