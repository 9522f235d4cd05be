"""DEQ trunk: the gcn blocks, the DEQ layer and its feed-forward variant."""
from .deq_layer import DEQLayer, DEQLayerConfig, FFDNetwork

__all__ = ["DEQLayer", "DEQLayerConfig", "FFDNetwork"]
