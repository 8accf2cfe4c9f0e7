"""YAML configs (host side): the port's copy of heal_tpu.config for the
parsers its configs name."""
from .loader import (PARSER_REGISTRY, keep_modalities, load_yaml, reparse,
                     save_yaml)

__all__ = ["load_yaml", "save_yaml", "reparse", "keep_modalities",
           "PARSER_REGISTRY"]
