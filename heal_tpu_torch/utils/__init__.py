"""Device-side utilities (torch) and the flax -> torch weight bridge."""
