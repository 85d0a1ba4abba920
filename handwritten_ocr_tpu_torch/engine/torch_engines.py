"""PyTorch engines: the preprocessor, the batched OCR backend, the
reasoning backend, and the pipeline over both.

Port of ``TPUPreprocessor``, the paged read path of ``JaxOCRBackend``, the
paged path of ``JaxReasoningBackend`` (free and schema-guided decode) and
``build_jax_pipeline`` (``handwritten_ocr_tpu/engine/jax_engines.py``).
The models stay resident on the device; the strategies of one page share
one batched vision + prefill + decode (every transform keeps the page
geometry, so they share a grid), and the turns of a chat batch share the
continuous batcher.

KV pools are planned for the card: each engine sizes its pool from a byte
budget (``pool_bytes``). Whoever builds both engines plans them together
(:func:`plan_pools`, one ``parallel/budget.py:coresident_plan`` of the
card's memory, both resident weight trees and a fixed activation
reserve); an engine built alone takes the whole remainder of the card
after its own weights and the reserve. A pool smaller than slots x
context only delays admission: requests queue until blocks retire.

Every entry point runs on the first CUDA card unless the caller passes
``device``; without a card and without a device they raise. Both backends
decode over an int8 KV cache unless the caller passes ``kv_quant=False``
(``config.SERVE_KV_INT8``, the same default on every device).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from handwritten_ocr_tpu_torch import config as cfg_mod
from handwritten_ocr_tpu_torch.engine.protocols import (PreparedImage,
                                                        strategy_label)
from handwritten_ocr_tpu_torch.models.processor import (TextTokenizer,
                                                        aligned_smart_size,
                                                        llm_chat_prompt,
                                                        load_image_rgb,
                                                        pack_image,
                                                        pack_image_device,
                                                        resize_bicubic,
                                                        vlm_chat_prompt)
from handwritten_ocr_tpu_torch.ops.dispatch import resolve_device

OLMOCR_DIR_ENV = "HOCR_OLMOCR_DIR"
QWEN3_DIR_ENV = "HOCR_QWEN3_DIR"


def _full_fp32_on_the_card() -> None:
    """fp32 products and convolutions in full fp32 on the card: TF32
    would keep about three decimal digits and drift from the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _card_bytes(device: torch.device) -> int:
    if device.type != "cuda":
        raise ValueError(f"no card memory to plan on {device}; pass the "
                         "budget in bytes")
    return torch.cuda.get_device_properties(device).total_memory


def _pool_blocks(owner, text_cfg, dtype: torch.dtype, max_blocks: int) -> int:
    """The engine's pool size in blocks: the full ``1 + slots x blocks``
    when its byte budget holds it, else as many as the budget holds.
    Budget: ``owner.pool_bytes``; None means the whole card after the
    engine's own weights and ``config.ACTIVATION_RESERVE_BYTES`` (the
    full pool on the CPU)."""
    from handwritten_ocr_tpu_torch.models.paged import PagedKVCache
    from handwritten_ocr_tpu_torch.parallel.budget import tree_bytes
    full = 1 + cfg_mod.SERVE_SLOTS * max_blocks
    budget = owner.pool_bytes
    if budget is None:
        if owner.device.type != "cuda":
            return full
        budget = (_card_bytes(owner.device) - tree_bytes(owner.model.params)
                  - cfg_mod.ACTIVATION_RESERVE_BYTES)
    per_block = PagedKVCache.block_bytes(
        text_cfg.num_hidden_layers, cfg_mod.SERVE_BLOCK_SIZE,
        text_cfg.num_key_value_heads, text_cfg.head_dim, dtype,
        owner.kv_quant)
    blocks = min(full, budget // per_block)
    if blocks < 2:
        raise RuntimeError(f"a KV pool budget of {budget} bytes holds no "
                           f"block of {per_block} bytes")
    return int(blocks)


def _ensure_batcher(owner, needed_context: int, text: dict, text_cfg,
                    eos_token_id: int):
    """``owner._batcher``, rebuilt when it is None or its context bound is
    below ``needed_context``. The bound rounds up to a power of two (floor
    512); the table-width ladder keeps attention reads length-bounded
    inside it, so rounding up costs only pool capacity, which the byte
    budget caps (:func:`_pool_blocks`). The old batcher (and its KV
    pools) is dropped, and the allocator's cache emptied, before the new
    pools are allocated: with both models resident the card cannot hold
    two sets of pools."""
    from handwritten_ocr_tpu_torch.engine.serving import (ContinuousBatcher,
                                                          PagedProgram)
    context = 512
    while context < needed_context:
        context *= 2
    if owner._batcher is not None and owner._batcher.max_context >= context:
        return owner._batcher
    owner._batcher = None
    if owner.device.type == "cuda":
        torch.cuda.empty_cache()
    block = cfg_mod.SERVE_BLOCK_SIZE
    dtype = text["embed"]["w"].dtype
    program = PagedProgram(text, text_cfg, eos_token_id=eos_token_id)
    owner._batcher = ContinuousBatcher(
        program, n_slots=cfg_mod.SERVE_SLOTS, block_size=block,
        n_blocks=_pool_blocks(owner, text_cfg, dtype, -(-context // block)),
        max_context=context, chunk=cfg_mod.SERVE_CHUNK,
        throughput_chunk=cfg_mod.SERVE_THROUGHPUT_CHUNK,
        prefill_bucket=cfg_mod.SERVE_PREFILL_BUCKET,
        dtype=dtype, device=owner.device, kv_quant=owner.kv_quant)
    return owner._batcher


def plan_pools(ocr, llm, card_bytes: int | None = None):
    """Plan both engines' KV pools on one card at once and hand each its
    budget (``pool_bytes``); returns the ``ServingPlan``.

    ``parallel/budget.py:coresident_plan`` with ``n_chips=1``, the card's
    memory (``card_bytes``, else the card of ``ocr.device``), the resident
    weights of both engines and ``config.ACTIVATION_RESERVE_BYTES``: the
    OCR pool holds ``SERVE_SLOTS`` reads at a 4096-token context, the
    reasoner's 8 agent calls at 16384 (the default budgets' bounds). Any
    batcher built before is dropped, so the next call builds within its
    budget."""
    from handwritten_ocr_tpu_torch.parallel.budget import (coresident_plan,
                                                           tree_bytes)
    if card_bytes is None:
        card_bytes = _card_bytes(ocr.device)
    plan = coresident_plan(
        ocr.model.config, llm.model.config, n_chips=1,
        hbm_per_chip=card_bytes, ocr_batch=cfg_mod.SERVE_SLOTS,
        vl_quant=_quant_label(ocr.model.params),
        llm_quant=_quant_label(llm.model.params),
        vl_weight_bytes=tree_bytes(ocr.model.params),
        llm_weight_bytes=tree_bytes(llm.model.params),
        activation_reserve=cfg_mod.ACTIVATION_RESERVE_BYTES)
    for engine, prefix in ((ocr, "vl_kv"), (llm, "llm_kv")):
        engine.pool_bytes = plan.component(prefix)
        engine._batcher = None
    return plan


def _quant_label(tree) -> str | None:
    """"int8" when the tree holds int8 projections."""
    if isinstance(tree, dict):
        return "int8" if "w_q" in tree or any(
            _quant_label(v) for v in tree.values()) else None
    if isinstance(tree, list):
        return "int8" if any(_quant_label(v) for v in tree) else None
    return None


class TorchPreprocessor:
    """Runs strategy chains on the device.

    The page (a PNG file, read without PIL, or a uint8 array) goes to the
    device and is resized there to its smart-resize target with PIL's
    bicubic (bit-equal to PIL, as the HF processor resamples), so the
    transform chain, patch packing and vision encode all see 28-aligned
    shapes.
    """

    def __init__(self, min_pixels: int = cfg_mod.OCR_MIN_PIXELS,
                 max_pixels: int = cfg_mod.OCR_MAX_PIXELS,
                 device: str | torch.device | None = None):
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.device = resolve_device(device)
        self._cache: dict[str, torch.Tensor] = {}

    def _load_aligned(self, image) -> torch.Tensor:
        key = image if isinstance(image, str) else None
        if key is not None and key in self._cache:
            return self._cache[key]
        pixels = load_image_rgb(image) if key is not None else np.asarray(image)
        tensor = torch.as_tensor(np.array(pixels, dtype=np.uint8),
                                 device=self.device)
        target = aligned_smart_size(pixels.shape[0], pixels.shape[1],
                                    min_pixels=self.min_pixels,
                                    max_pixels=self.max_pixels)
        if target != tuple(pixels.shape[:2]):
            tensor = resize_bicubic(tensor, target)
        if key is not None:
            self._cache = {key: tensor}           # one page at a time
        return tensor

    def apply(self, image, strategy) -> PreparedImage:
        """``image``: a file path or a uint8 [H, W(, 3)] array."""
        from handwritten_ocr_tpu_torch.ops.bank import preprocess_chain
        processed = preprocess_chain(self._load_aligned(image), strategy)
        return PreparedImage(data=processed,
                             strategy_label=strategy_label(strategy),
                             source_path=image if isinstance(image, str)
                             else "<array>")


class TorchOCRBackend:
    """Batched VLM OCR over preprocessed device images, decoded through
    the continuous batcher over the paged KV cache.

    ``stats`` accumulates host-clock seconds of the vision tower (with a
    device sync at its end), and the batcher's prefill and decode seconds.
    ``pool_bytes``: the KV pool's byte budget (None: plan alone, see
    :func:`_pool_blocks`).
    """

    def __init__(self, model, tokenizer: TextTokenizer,
                 device: str | torch.device | None = None,
                 min_pixels: int = cfg_mod.OCR_MIN_PIXELS,
                 max_pixels: int = cfg_mod.OCR_MAX_PIXELS,
                 kv_quant: bool = cfg_mod.SERVE_KV_INT8,
                 pool_bytes: int | None = None):
        self.device = resolve_device(device)
        _full_fp32_on_the_card()
        self.model = model
        self.tokenizer = tokenizer
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.kv_quant = kv_quant
        self.pool_bytes = pool_bytes
        self._batcher = None
        self.stats = {"vision_s": 0.0}

    def _ensure_batcher(self, needed_context: int):
        config = self.model.config
        return _ensure_batcher(self, needed_context, self.model.params["text"],
                               config.text, config.eos_token_id)

    def _prompt_ids(self, prompt: str, n_image_tokens: int) -> np.ndarray:
        image_token = self.model.config.image_token_id
        # Tokenize with one placeholder, then expand to the real count.
        ids = self.tokenizer.encode(vlm_chat_prompt(prompt, num_image_tokens=1))
        out: list[int] = []
        for tok in ids:
            out.extend([image_token] * n_image_tokens if tok == image_token
                       else [tok])
        return np.array(out, dtype=np.int32)

    @classmethod
    def from_pretrained(cls, model_dir: str | Path,
                        dtype: torch.dtype = torch.bfloat16,
                        quantize: str | None = None,
                        device: str | torch.device | None = None,
                        **kwargs) -> "TorchOCRBackend":
        """The engine of a local snapshot: a native checkpoint where the
        directory holds ``meta.json`` (``models/checkpoint.py``), else an
        HF snapshot (``config.json``, ``*.safetensors``), each with its
        ``tokenizer.json``. Tensors go to ``device`` as they are read."""
        from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
        from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
        device = resolve_device(device)
        model_dir = Path(model_dir)
        if (model_dir / "meta.json").exists():
            from handwritten_ocr_tpu_torch.models.checkpoint import (
                load_checkpoint)
            params, meta = load_checkpoint(model_dir, device)
            config = VLConfig.from_hf(meta["hf_config"])
            if quantize == "int8":
                from handwritten_ocr_tpu_torch.models.quant import quantize_tree
                params = quantize_tree(params)
        else:
            from handwritten_ocr_tpu_torch.models.weights import convert_vl
            config = VLConfig.from_pretrained_dir(model_dir)
            params = convert_vl(model_dir, config, dtype=dtype, device=device,
                                quantize=quantize)
        return cls(VLModel(params, config), _tokenizer(model_dir),
                   device=device, **kwargs)

    def _pack_one(self, data):
        """(patches, grid) of one image: on the device for a 28-aligned
        device image (``TorchPreprocessor`` output), else on the host
        through ``pack_image`` (smart resize + PIL's bicubic), as the JAX
        engine does."""
        if isinstance(data, torch.Tensor) and data.dim() in (2, 3) \
                and data.shape[0] % 28 == 0 and data.shape[1] % 28 == 0:
            return pack_image_device(data.to(self.device))
        host = data.cpu().numpy() if isinstance(data, torch.Tensor) \
            else np.asarray(data)
        packed = pack_image(host, min_pixels=self.min_pixels,
                            max_pixels=self.max_pixels)
        return (torch.as_tensor(packed.patches, device=self.device),
                packed.grid)

    def _grid_groups(self, images: Sequence):
        """Pack images and group identical grids (all strategies of one
        page share a grid; mixed-page batches fall into grid groups)."""
        packed = [self._pack_one(getattr(img, "data", img)) for img in images]
        order = sorted(range(len(packed)), key=lambda i: packed[i][1])
        start = 0
        while start < len(order):
            end = start
            grid = packed[order[start]][1]
            while end < len(order) and packed[order[end]][1] == grid:
                end += 1
            group = order[start:end]
            yield group, grid, torch.stack([packed[i][0] for i in group])
            start = end

    def read_batch(self, images: Sequence, prompt: str,
                   max_new_tokens: int) -> list[str]:
        """Vision encode + splice per grid group, then all pages decode
        together through the continuous batcher."""
        from handwritten_ocr_tpu_torch.engine.serving import GenRequest
        from handwritten_ocr_tpu_torch.models.qwen25vl.model import (
            rope_index_for_prompt)

        requests: list[GenRequest | None] = [None] * len(images)
        longest = 0
        for group, grid, patches in self._grid_groups(images):
            t0 = time.perf_counter()
            n_llm_tokens = grid[0] * grid[1] * grid[2] // 4
            ids_row = self._prompt_ids(prompt, n_llm_tokens)
            positions, delta = rope_index_for_prompt(
                ids_row, self.model.config, [grid])
            input_ids = torch.as_tensor(np.tile(ids_row, (len(group), 1)),
                                        dtype=torch.long, device=self.device)
            embeds = self.model.prompt_embeds(input_ids, patches, grid)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stats["vision_s"] += time.perf_counter() - t0
            longest = max(longest, len(ids_row))
            for row, img_idx in enumerate(group):
                requests[img_idx] = GenRequest(
                    prompt_ids=ids_row, max_new=max_new_tokens,
                    positions=positions, rope_delta=delta, embeds=embeds[row])
        batcher = self._ensure_batcher(longest + max_new_tokens)
        token_lists = batcher.run(requests)  # type: ignore[arg-type]
        return [self.tokenizer.decode(tokens) for tokens in token_lists]

    def read(self, image, prompt: str, max_new_tokens: int) -> str:
        return self.read_batch([image], prompt, max_new_tokens)[0]

    def release(self) -> None:
        """No-op: the model stays resident on the device."""


class TorchReasoningBackend:
    """Qwen3 chat decode for the critic / editor / arbitrator: greedy
    decode through the continuous batcher over the paged KV cache, free
    or schema-guided (``json_schema``).

    ``model`` is a :class:`~handwritten_ocr_tpu_torch.models.qwen3.
    Qwen3Model`` (bf16 or int8 weights).
    """

    def __init__(self, model, tokenizer: TextTokenizer,
                 enable_thinking: bool = cfg_mod.LLM_ENABLE_THINKING,
                 stream: bool = False,
                 device: str | torch.device | None = None,
                 kv_quant: bool = cfg_mod.SERVE_KV_INT8,
                 pool_bytes: int | None = None):
        self.device = resolve_device(device)
        _full_fp32_on_the_card()
        self.model = model
        self.tokenizer = tokenizer
        self.enable_thinking = enable_thinking
        # Live token streaming to stdout for single-request calls.
        self.stream = stream
        self.kv_quant = kv_quant
        self.pool_bytes = pool_bytes
        self._batcher = None

    @classmethod
    def from_pretrained(cls, model_dir: str | Path,
                        dtype: torch.dtype = torch.bfloat16,
                        quantize: str | None = None,
                        device: str | torch.device | None = None,
                        **kwargs) -> "TorchReasoningBackend":
        """The engine of a local snapshot (native checkpoint or HF
        snapshot, as :meth:`TorchOCRBackend.from_pretrained`).
        ``quantize="int8"`` quantises each layer as it is read, so the
        32B model never exists in bf16 on the card."""
        from handwritten_ocr_tpu_torch.models.qwen3 import (Qwen3Config,
                                                            Qwen3Model)
        device = resolve_device(device)
        model_dir = Path(model_dir)
        if (model_dir / "meta.json").exists():
            from handwritten_ocr_tpu_torch.models.checkpoint import (
                load_checkpoint)
            params, meta = load_checkpoint(model_dir, device)
            config = Qwen3Config.from_hf(meta["hf_config"])
            if quantize == "int8":
                from handwritten_ocr_tpu_torch.models.quant import quantize_tree
                params = quantize_tree(params)
        else:
            from handwritten_ocr_tpu_torch.models.weights import convert_qwen3
            config = Qwen3Config.from_pretrained_dir(model_dir)
            params = convert_qwen3(model_dir, config, dtype=dtype,
                                   device=device, quantize=quantize)
        return cls(Qwen3Model(params, config), _tokenizer(model_dir),
                   device=device, **kwargs)

    def _ensure_batcher(self, needed_context: int):
        config = self.model.config
        return _ensure_batcher(self, needed_context, self.model.params,
                               config, config.eos_token_id)

    def _stream_printer(self):
        """on_tokens callback: prints the decoded text incrementally."""
        state = {"ids": [], "printed": ""}

        def emit(new_tokens: list[int], done: bool) -> None:
            state["ids"].extend(new_tokens)
            text = self.tokenizer.decode(state["ids"])
            if not done:
                text = text.rstrip("\ufffd")   # hold an incomplete multibyte
            if text.startswith(state["printed"]):
                delta = text[len(state["printed"]):]
            else:                              # the decoder backtracked
                delta = ""
            if delta:
                print(delta, end="", flush=True)
                state["printed"] = text
            if done:
                print(flush=True)
        return emit

    def _generate_paged(self, encoded: list[list[int]],
                        max_tokens: int) -> list[str]:
        """Every prompt through the continuous batcher; returns the texts.
        Streams to stdout only for a single request (interleaved streams
        would garble the console)."""
        from handwritten_ocr_tpu_torch.engine.serving import GenRequest
        longest = max(len(ids) for ids in encoded)
        batcher = self._ensure_batcher(longest + max_tokens)
        stream = (self._stream_printer()
                  if self.stream and len(encoded) == 1 else None)
        requests = [GenRequest(np.asarray(ids, np.int32), max_tokens,
                               on_tokens=stream) for ids in encoded]
        token_lists = batcher.run(requests)
        return [self.tokenizer.decode(tokens) for tokens in token_lists]

    def _chat_guided(self, encoded: list[list[int]], json_schema: dict,
                     max_tokens: int) -> list[str | None]:
        """Schema-constrained decode of a batch of prompts: the host forces
        the JSON scaffolding and type-constrains every value, so each
        non-None result validates against ``json_schema``. None: the model
        emitted EOS (or spent its budget) before a required field."""
        from handwritten_ocr_tpu_torch.engine.serving import GenRequest
        longest = max(len(ids) for ids in encoded)
        batcher = self._ensure_batcher(longest + max_tokens)
        requests = [GenRequest(np.asarray(ids, np.int32), max_tokens)
                    for ids in encoded]
        outcomes = batcher.run_guided(requests, json_schema, self.tokenizer)
        return [(json.dumps(obj) if obj is not None and complete else None)
                for obj, complete in outcomes]

    def _encode(self, system: str, user: str) -> list[int]:
        return self.tokenizer.encode(llm_chat_prompt(
            system, user, enable_thinking=self.enable_thinking))

    def chat(self, system_prompt: str, user_message: str, *,
             temperature: float, max_tokens: int,
             json_schema: dict | None = None) -> str:
        """Greedy chat decode; ``json_schema`` asks for schema-constrained
        JSON (forced scaffolding, type-constrained values), with free
        decode when the guided session is not complete (the caller's parse
        ladder takes over). ``temperature`` is accepted for protocol
        parity (the pipeline uses 0.1, close to greedy)."""
        ids = self._encode(system_prompt, user_message)
        if json_schema is not None:
            [constrained] = self._chat_guided([ids], json_schema, max_tokens)
            if constrained is not None:
                return constrained
        return self._generate_paged([ids], max_tokens)[0]

    def chat_batch(self, requests, *, temperature: float, max_tokens: int,
                   json_schema: dict | None = None) -> list[str]:
        """Many chat turns (objects with ``.system`` and ``.user``) as one
        continuous batch: mixed-length prompts skip the pad-to-longest
        prefill, and a turn that hits EOS frees its slot for the queue.
        With ``json_schema`` the batch runs schema-guided; rows whose
        session is not complete fall back to free decode."""
        encoded = [self._encode(r.system, r.user) for r in requests]
        if json_schema is None:
            return self._generate_paged(encoded, max_tokens)
        texts = self._chat_guided(encoded, json_schema, max_tokens)
        missing = [i for i, text in enumerate(texts) if text is None]
        if missing:
            free = self._generate_paged([encoded[i] for i in missing],
                                        max_tokens)
            for index, text in zip(missing, free):
                texts[index] = text
        return texts  # type: ignore[return-value]


def _tokenizer(model_dir: Path):
    from handwritten_ocr_tpu_torch.models.tokenizer import BPETokenizer
    return BPETokenizer.from_dir(model_dir)


def build_torch_pipeline(quiet: bool = False,
                         device: str | torch.device | None = None):
    """The full pipeline from local checkpoints (``HOCR_OLMOCR_DIR``,
    ``HOCR_QWEN3_DIR``): olmOCR-2 in bf16 and the reasoner quantised to
    int8 at load, both resident on one card with their pools planned
    together (:func:`plan_pools`; the plan is printed unless ``quiet``)."""
    from handwritten_ocr_tpu_torch.engine.prefetch import PrimedOCRBackend
    from handwritten_ocr_tpu_torch.graph.driver import OCRPipeline
    ocr_dir = os.environ.get(OLMOCR_DIR_ENV)
    llm_dir = os.environ.get(QWEN3_DIR_ENV)
    missing = [name for name, val in
               [(OLMOCR_DIR_ENV, ocr_dir), (QWEN3_DIR_ENV, llm_dir)]
               if not val or not Path(val).exists()]
    if missing:
        raise SystemExit(
            "torch backend needs local model checkpoints. Set "
            + " and ".join(missing)
            + " to directories containing config.json + *.safetensors + "
              "tokenizer files (HF snapshots of "
              f"{cfg_mod.OLMOCR_MODEL} and a Qwen3 reasoning model). "
              "For a model-free smoke run use --backend dryrun."
        )
    if not quiet:
        print(f"  [engine] Loading OCR model from {ocr_dir}...")
    ocr = TorchOCRBackend.from_pretrained(ocr_dir, device=device)
    if not quiet:
        print(f"  [engine] Loading reasoning model from {llm_dir}...")
    llm = TorchReasoningBackend.from_pretrained(llm_dir, quantize="int8",
                                                device=device)
    llm.stream = not quiet       # live token streaming
    if ocr.device.type == "cuda":        # on the CPU each pool is full
        plan = plan_pools(ocr, llm)
        if not quiet:
            print(f"  [engine] {torch.cuda.get_device_name(ocr.device)}")
            print(plan.report())
    return OCRPipeline(PrimedOCRBackend(ocr), llm,
                       preprocessor=TorchPreprocessor(device=ocr.device),
                       quiet=quiet)
