"""Host-side data (numpy): the port's copy of heal_tpu.data for the
synthetic backend and the intermediate, late and early assemblers."""
from .builder import assembler_class, build_dataset

__all__ = ["assembler_class", "build_dataset"]
