"""The change lattice of incremental computation (data types only)."""
