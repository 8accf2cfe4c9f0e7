"""Host-side data (numpy): the port's copy of heal_tpu.data: the
synthetic and disk backends (OPV2V / V2XSet, DAIR-V2X-C, V2X-Sim) and
the intermediate, late and early assemblers."""
from .builder import assembler_class, build_dataset

__all__ = ["assembler_class", "build_dataset"]
