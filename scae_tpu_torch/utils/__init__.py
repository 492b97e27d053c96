"""Utilities: shapes, the flax-parameter bridge and device choice."""
