"""DEQ trunk: the gcn blocks and the DEQ layer."""
from .deq_layer import DEQLayer, DEQLayerConfig

__all__ = ["DEQLayer", "DEQLayerConfig"]
