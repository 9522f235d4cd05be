"""DEQ trunks: the gcn and mlp blocks, the DEQ layer, its feed-forward
variant and the layers of the policy variants."""
from .deq_layer import DEQLayer, DEQLayerConfig, FFDNetwork
from .deq_layer_variants import (DEQLayerDelta, DEQLayerFeedback, DEQLayerHistory,
                                 DEQLayerHistoryState, DEQLayerHistoryStateEstPred, DEQLayerMem,
                                 DEQLayerQ)

__all__ = ["DEQLayer", "DEQLayerConfig", "DEQLayerDelta", "DEQLayerFeedback", "DEQLayerHistory",
           "DEQLayerHistoryState", "DEQLayerHistoryStateEstPred", "DEQLayerMem", "DEQLayerQ",
           "FFDNetwork"]
