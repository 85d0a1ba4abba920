"""PyTorch / CUDA port of the handwritten-OCR read path for NVIDIA Hopper.

The package mirrors the layout of ``handwritten_ocr_tpu`` (the JAX
reference) module for module, so each file here has a counterpart of the
same name there. It imports ``torch`` and ``numpy`` only: no JAX and
nothing of the JAX package. The three attention kernels of the read path
are hand-written CUDA C++ for ``sm_90a`` under ``csrc/``, built with
``nvcc`` at first use (``ops/build.py``); CPU tensors take each kernel's
plain PyTorch version instead (``ops/dispatch.py``).

Entry point of the slice: ``engine.torch_engines.TorchOCRBackend.read_batch``.
"""

__version__ = "0.1.0"
