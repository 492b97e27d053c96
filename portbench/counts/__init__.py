"""The benchmark's yardstick: operations and bytes from shapes, and the
card's published peaks."""
