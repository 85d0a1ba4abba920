"""Image transforms and the hand-written CUDA kernels of the read path."""


def launch_counters():
    """(name, wrapper, attribute) of every kernel launch count: each
    wrapper counts its launches in a function attribute."""
    from handwritten_ocr_tpu_torch.ops.flash_attention import flash_attention
    from handwritten_ocr_tpu_torch.ops.int8_matmul import int8_matmul
    from handwritten_ocr_tpu_torch.ops.paged_decode_attention import (
        paged_append_attention)
    from handwritten_ocr_tpu_torch.ops.window_attention import (
        window_attention)
    return (("flash_attention", flash_attention, "launches"),
            ("window_attention", window_attention, "launches"),
            ("paged_append_attention", paged_append_attention, "launches"),
            ("paged_append_attention_int8", paged_append_attention,
             "int8_launches"),
            ("paged_append_attention_fp32", paged_append_attention,
             "fp32_launches"),
            ("int8_matmul", int8_matmul, "launches"))
