"""Data types of the compiler layer (no jaxpr machinery in the port)."""
