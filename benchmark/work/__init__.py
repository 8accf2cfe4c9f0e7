"""The yardstick: the chip's published peaks, and the operations and
bytes each measured kernel's function needs, counted from the shapes and
the data of its calls, whatever implements it."""
