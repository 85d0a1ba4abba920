"""Host-side pipeline graph: nodes, routing, and the driver loops (port of
``handwritten_ocr_tpu/graph``)."""

from handwritten_ocr_tpu_torch.graph.driver import OCRPipeline
from handwritten_ocr_tpu_torch.graph.routing import (route_after_critic,
                                                     route_after_reocr)

__all__ = ["route_after_critic", "route_after_reocr", "OCRPipeline"]
