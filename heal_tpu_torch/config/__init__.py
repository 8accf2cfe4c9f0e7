"""YAML configs (host side): the port's copy of heal_tpu.config for the
parsers its configs name."""
from .loader import PARSER_REGISTRY, load_yaml, save_yaml

__all__ = ["load_yaml", "save_yaml", "PARSER_REGISTRY"]
