"""``python -m handwritten_ocr_tpu_torch``: the port's CLI
(``cli/transcribe.py``)."""

from handwritten_ocr_tpu_torch.cli.transcribe import main

main()
