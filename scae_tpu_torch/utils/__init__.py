"""Utilities: shapes, the flax-parameter bridge, device choice, the PNG
writer, and the port's spans and counters (``trace``)."""
