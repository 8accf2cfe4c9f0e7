"""Host-side data (numpy): the port's copy of heal_tpu.data for the
synthetic backend and intermediate fusion."""
from .builder import build_dataset

__all__ = ["build_dataset"]
