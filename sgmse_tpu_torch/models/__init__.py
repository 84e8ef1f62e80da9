"""Score-network backbones. Importing this package registers them with the
BackboneRegistry."""
from .registry import BackboneRegistry
from .ncsnpp import NCSNpp, NCSNpp_48k, NCSNpp_v2, NCSNppBase
from .dcunet import DCUNet

__all__ = ["BackboneRegistry", "DCUNet", "NCSNpp", "NCSNpp_48k", "NCSNpp_v2", "NCSNppBase"]
