"""Qwen2.5-VL (olmOCR-2 architecture): vision tower and text decoder."""
