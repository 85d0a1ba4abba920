"""Model code of the port: layers, Qwen2.5-VL, the paged KV cache."""
