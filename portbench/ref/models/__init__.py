from .deq_layer import DEQLayer, DEQLayerConfig, FFDNetwork
