"""The OCR read: folders of page photographs through the port's read
path, as ``TorchOCRBackend._read_batch_paged`` runs it, with each page's
own token budget.

For every folder: ``TorchPreprocessor.apply`` for each page under each
of the cell's strategies (a range ending in a synchronise), the packing
and ``VLModel.prompt_embeds`` (vision tower + splice) per grid group (a
range ending in a synchronise), then one ``ContinuousBatcher.run`` over
a ``GenRequest`` per read on the engine's own batcher
(``_ensure_batcher``). A page is complete when all its reads are.

After the window: the program's state is freed, and the plain reference
reads a sample of the completed reads again from the raw pages
(preprocessing, vision tower, splice, decoder; float32) and takes the
mean and the widest gap of the served tokens.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark import weights
from benchmark.drivers.common import (Run, Window, WindowClosed, instrument,
                                      reset_counters, sample)
from benchmark.reference import compare, models as ref_models
from benchmark.reference import preprocess as ref_pre
from benchmark.reference import tokens as ref_tokens
from benchmark.tracing import Ranges
from benchmark.traffic.pages import folders as make_folders
from benchmark.work import Work


def _program(cfg, units, seed: int, device, control: bool, std: float):
    """The engine over the benchmark's weights; the control quantises
    them to int8 as ``TorchOCRBackend.from_pretrained(quantize="int8")``
    does."""
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchPreprocessor)
    from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
    params = weights.assemble(units, seed, device, torch.bfloat16, std=std)
    if control:
        from handwritten_ocr_tpu_torch.models.quant import quantize_tree
        params = {"vision": quantize_tree(params["vision"]),
                  "text": quantize_tree(params["text"])}
        params["text"]["lm_head"] = quantize_tree(
            {"lm_head": params["text"]["lm_head"]})["lm_head"]
    backend = TorchOCRBackend(VLModel(params, cfg), ByteTokenizer(),
                              device=device)
    return backend, TorchPreprocessor(device=device)


class Reader:
    def __init__(self, backend, prep, cell: dict, ranges: Ranges,
                 work: Work | None):
        self.backend, self.prep, self.cell = backend, prep, cell
        self.ranges, self.work = ranges, work

    def context(self, page_shape, budgets) -> int:
        """The context bound the engine asks its batcher for: the prompt
        and the largest budget of the call."""
        cfg = self.backend.model.config
        h, w = page_shape[:2]
        cells = (h // cfg.vision.patch_size) * (w // cfg.vision.patch_size) \
            // cfg.vision.spatial_merge_size ** 2
        return len(self.backend._prompt_ids(self.cell["prompt"], cells)) \
            + max(budgets)

    def requests(self, pages, budgets):
        from handwritten_ocr_tpu_torch.engine.serving import GenRequest
        from handwritten_ocr_tpu_torch.models.qwen25vl.model import (
            rope_index_for_prompt)
        backend, model = self.backend, self.backend.model
        strategies = self.cell["strategies"]
        with self.ranges.range("preprocess", sync=True):
            images = [self.prep.apply(page, s) for page in pages
                      for s in strategies]
        out = [None] * len(images)
        with self.ranges.range("vision", sync=True):
            for group, grid, patches in backend._grid_groups(images):
                n_llm = grid[0] * grid[1] * grid[2] // 4
                ids = backend._prompt_ids(self.cell["prompt"], n_llm)
                positions, delta = rope_index_for_prompt(ids, model.config,
                                                         [grid])
                input_ids = torch.as_tensor(np.tile(ids, (len(group), 1)),
                                            dtype=torch.long,
                                            device=backend.device)
                embeds = model.prompt_embeds(input_ids, patches, grid)
                for row, index in enumerate(group):
                    out[index] = GenRequest(
                        prompt_ids=ids, max_new=budgets[index // len(strategies)],
                        positions=positions, rope_delta=delta,
                        embeds=embeds[row])
                if self.work is not None and not self.work.frozen:
                    self.work.grids.extend([tuple(grid)] * len(group))
        return out

    def read(self, pages, budgets, batcher_context: int):
        requests = self.requests(pages, budgets)
        batcher = self.backend._ensure_batcher(batcher_context)
        with self.ranges.range("batcher.run"):
            batcher.run(requests)
        return requests


def run(env) -> Run:
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
    cell, device, seed = env.cell, env.device, env.seed
    cfg = VLConfig.from_hf(env.config["hf"])
    units = weights.vl_units(cfg)
    std = env.config.get("init_std", weights.STD)
    backend, prep = _program(cfg, units, seed, device, env.control, std)
    folders = make_folders(cell, seed, device)
    n_strategies = len(cell["strategies"])
    ranges = Ranges(profile=False)
    warm = Reader(backend, prep, cell, ranges, None)
    context = warm.context(folders[0]["pages"][0].shape,
                           [max(f["budgets"]) for f in folders])

    # Warm-up on the batcher the window will use, at the cell's shapes:
    # full vision chunks, a prefill of every slot and one of a single
    # page, and decode steps.
    pages = folders[0]["pages"]
    full = [pages[i % len(pages)] for i in range(24 // n_strategies)]
    warm.read(full, [2] * len(full), context)
    warm.read(pages[:1], [2], context)
    batcher = backend._ensure_batcher(context)
    env.sync()
    env.mark_setup()

    work = Work() if env.trace else None
    ranges = Ranges(profile=env.trace)
    frozen: dict = {}

    def stop_tracing() -> None:
        """A traced run that closes at a folder's end traces until the
        first decode chunk that starts past ``--seconds``, not to the
        end: reading the trace of a whole notebook would take most of the
        360 s a run has. The per-layer numbers are taken over the traced part (the
        counters as they stood, the work and ranges counted until then);
        the folder goes on untraced, so that its reads finish."""
        frozen["counters"] = dict(batcher.stats)
        work.frozen = ranges.frozen = True
        env.stop_trace(ranges, window.t_open, time.perf_counter())

    window = Window(env.seconds, cell["close_at"],
                    on_due=stop_tracing if env.trace else None)
    instrument(batcher, window, ranges, work, env.faults)
    reader = Reader(backend, prep, cell, ranges, work)
    reset_counters(batcher)
    env.start_trace()
    window.open()
    reads = []                     # (pass, folder, page, strategy, request)
    try:
        index = 0
        while True:
            folder = folders[index % len(folders)]
            requests = reader.requests(folder["pages"], folder["budgets"])
            for i, request in enumerate(requests):
                reads.append((index, index % len(folders), i // n_strategies,
                              i % n_strategies, request))
            with ranges.range("batcher.run"):
                backend._ensure_batcher(context).run(requests)
            index += 1
            if window.close_at == "folder" and window.due():
                window.close()
                break
    except WindowClosed:
        pass
    window.close()
    if "counters" not in frozen:
        env.stop_trace(ranges, window.t_open, window.t_close)
    counters = frozen.get("counters", dict(batcher.stats))
    memory_peak = env.memory_peak()

    done = [r for r in reads if r[4].done]
    by_page: dict = {}
    for index, _, page, _, request in reads:
        by_page.setdefault((index, page), []).append(request.done)
    pages_done = sum(all(flags) for flags in by_page.values())
    rates = {"ocr_pages_per_s": pages_done / window.length}
    by_eos = sum(len(r[4].tokens) < r[4].max_new for r in done)
    print(f"window {window.length:.3f} s: {pages_done} pages, {len(done)} "
          f"reads done ({by_eos} by EOS) of {len(reads)} started",
          file=sys.stderr)
    chosen = sample(done, lambda r: len(r[4].tokens), cell["sample_reads"], seed)
    checked = [(folders[f]["pages"][p], cell["strategies"][s],
                list(r.tokens), len(r.tokens) < r.max_new)
               for _, f, p, s, r in chosen]
    eos = cfg.eos_token_id
    for *_, request in reads:
        request.embeds = None
    del reads, done, chosen, batcher, reader, warm, backend, prep
    env.free()

    checks = {}
    if checked:
        numbers = reference_gaps(cfg, units, seed, device, cell, checked,
                                 eos, std)
        print("served tokens compared: " + ", ".join(
            f"{k} {v!r}" for k, v in numbers.items()), file=sys.stderr)
        checks = {name: (numbers[name], limit)
                  for name, limit in cell["limits"].items()}
    else:
        checks["reads_checked"] = (0, 1, "min")
    return Run(rates=rates, attempted=pages_done, failed=0,
               counters=counters, ranges=ranges, work=work or Work(),
               window=window, checks=checks, memory_peak=memory_peak)


def reference_gaps(cfg, units, seed, device, cell, checked, eos,
                   std: float = weights.STD) -> dict:
    """The widest and the mean gap of the served tokens of ``checked``
    (page, strategy, tokens, ended by EOS) under the float32 reference."""
    ref_models.full_fp32()
    weights_of = ref_models.provider(
        lambda name: weights.draw_unit(units, name, seed, device,
                                       torch.bfloat16, std), torch.bfloat16)
    images = [ref_pre.patches(ref_pre.apply(page, strategy))
              for page, strategy, _, _ in checked]
    embeds = ref_models.vision(weights_of, cfg.vision, images, device)
    seqs, served = [], []
    for (patches, grid), image, (_, _, toks, by_eos) in zip(images, embeds,
                                                           checked):
        prompt = ref_tokens.ocr_prompt(cell["prompt"], image.shape[0])
        ids = prompt + toks
        target = toks + ([eos] if by_eos else [])
        seqs.append({"ids": ids, "image": image, "prompt": len(prompt),
                     "image_token": ref_tokens.IMAGE_TOKEN,
                     "positions": ref_tokens.mrope_positions(
                         ids, grid, cfg.vision.spatial_merge_size,
                         len(prompt)),
                     "want": list(range(len(prompt) - 1,
                                        len(prompt) - 1 + len(target)))})
        served.append(target)
    logits = ref_models.decoder_logits(weights_of, cfg.text, seqs, device)
    every = torch.cat([compare.gaps(l, t) for l, t in zip(logits, served)])
    return {"max_logit_gap": float(every.max()),
            "mean_logit_gap": float(every.mean()),
            "tokens_compared": int(every.numel())}
