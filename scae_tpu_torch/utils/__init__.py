"""Utilities: shapes, the flax-parameter bridge, device choice and the PNG
writer."""
