"""Utilities: the device side (torch) and the flax -> torch weight bridge;
the numpy host side (``*_np.py``, ``pose_noise.py``)."""
