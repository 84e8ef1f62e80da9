"""Score-network backbones. Importing this package registers them with the
BackboneRegistry."""
from .registry import BackboneRegistry
from .ncsnpp import NCSNpp, NCSNppBase

__all__ = ["BackboneRegistry", "NCSNpp", "NCSNppBase"]
