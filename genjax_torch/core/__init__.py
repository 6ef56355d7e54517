"""Substrate: pytrees, types, checks and the functional key layer."""
