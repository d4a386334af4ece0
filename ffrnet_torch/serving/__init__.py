"""Serving on the card: the micro-batching EmbeddingService and its HTTP
front (counterpart of ffrnet_tpu/serving/)."""

from ffrnet_torch.serving.http import EmbeddingHTTPServer
from ffrnet_torch.serving.service import EmbeddingService, ServiceStats

__all__ = ["EmbeddingHTTPServer", "EmbeddingService", "ServiceStats"]
