"""PyTorch / CUDA port of the handwritten-OCR engines for NVIDIA Hopper.

The package mirrors the layout of ``handwritten_ocr_tpu`` (the JAX
reference) module for module, so each file here has a counterpart of the
same name there. It imports ``torch`` and ``numpy`` only: no JAX and
nothing of the JAX package. The kernels (flash, window and paged
attention, the int8 weight matmul) are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(``ops/build.py``); CPU tensors take each kernel's plain PyTorch version
instead (``ops/dispatch.py``).

Entry points: ``engine.torch_engines.TorchOCRBackend.read_batch`` (the OCR
read), ``engine.torch_engines.TorchReasoningBackend.chat_batch`` (the
reasoning engine, free or schema-guided decode), and the pipeline over
both: ``graph.driver.OCRPipeline.run`` (one page through the critic /
editor / re-OCR / arbitrator loop) and
``graph.batch_driver.LockstepPipeline.run_many`` (many pages in lockstep,
one batched call per phase).
"""

__version__ = "0.1.0"
