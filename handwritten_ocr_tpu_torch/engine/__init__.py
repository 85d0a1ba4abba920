"""Engines of the port: the continuous batcher and the OCR backend."""
