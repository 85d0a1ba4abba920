"""Lockstep multi-page driver: batched agentic control flow (port of
``handwritten_ocr_tpu/graph/batch_driver.py``).

Pages in a batch finish at different iterations; this driver advances
MANY pages through the critique/edit/re-OCR loop in lockstep — at every
round, all pages sitting at the same node execute as ONE batched call
(OCR reads via ``read_batch``, reasoning agents via
``call_llm_json_batch`` → one guided ``chat_batch``), with per-page
routing and early exit. Node semantics per page are identical to
:class:`~handwritten_ocr_tpu_torch.graph.driver.OCRPipeline`; only the
execution schedule differs.
"""

from __future__ import annotations

from typing import Sequence

from handwritten_ocr_tpu_torch.agents.runners import (arbitrator_request,
                                                      critic_request,
                                                      editor_request,
                                                      parse_arbitrator,
                                                      parse_critic,
                                                      parse_editor)
from handwritten_ocr_tpu_torch.agents.schemas import CriticResult
from handwritten_ocr_tpu_torch.engine.llm_client import call_llm_json_batch
from handwritten_ocr_tpu_torch.engine.protocols import (PreparedImage,
                                                        strategy_label)
from handwritten_ocr_tpu_torch.graph.driver import (OCRPipeline,
                                                    _PassthroughPreprocessor)
from handwritten_ocr_tpu_torch.graph.routing import (route_after_critic,
                                                     route_after_reocr)
from handwritten_ocr_tpu_torch.state import OCRState, trace_log
from handwritten_ocr_tpu_torch.text.diff import compare_versions
from handwritten_ocr_tpu_torch.text.merge import merge_versions


class LockstepPipeline:
    """Drives a group of pages through the graph with batched model calls."""

    def __init__(self, ocr, llm, preprocessor=None, quiet: bool = True):
        self.ocr = ocr
        self.llm = llm
        self.preprocessor = preprocessor or _PassthroughPreprocessor()
        self.quiet = quiet
        # Single-page pipeline reused for per-page node bookkeeping helpers.
        self._solo = OCRPipeline(ocr, llm, self.preprocessor, quiet=quiet)

    # ── phase 1: batched initial reads across all pages ───────────
    def _initial_ocr_all(self, states: list[dict]) -> None:
        # (page, img, label, buffered preprocess event) — the preprocess
        # event is spliced in right before its ocr event so every page's
        # trace interleaves per pass, as the single-page driver's does.
        plans: list[tuple[int, PreparedImage, str, dict]] = []
        for index, state in enumerate(states):
            strategies = list(state["config"]["strategies"])[:2] or ["original"]
            seen: set[str] = set()
            for strategy in strategies:
                label = strategy_label(strategy)
                if label in seen:
                    continue
                seen.add(label)
                prepared = self.preprocessor.apply(state["image_path"], strategy)
                pre_event = trace_log(
                    state, iteration=0, agent="reader", action="preprocess",
                    input_summary=f"Image: {state['image_path']}",
                    output_summary=f"Preprocessed with '{label}'",
                    metrics={"strategy": label}, quiet=self.quiet)
                plans.append((index, prepared, label, pre_event))
                state["strategies_used"].append(label)

        texts = self._read([img for _, img, _, _ in plans],
                           [states[index] for index, _, _, _ in plans])
        for (index, _, label, pre_event), text in zip(plans, texts):
            state = states[index]
            state["candidates"].append({
                "text": text, "source": f"ocr_{label}",
                "ocr_params": {"strategy": label}, "score": None})
            state["trace_events"].append(pre_event)
            state["trace_events"].append(trace_log(
                state, iteration=0, agent="reader", action="ocr",
                input_summary=f"Preprocessed image ({label})",
                output_summary=f"OCR pass ({label}) → {len(text)} chars",
                full_output={"text_preview": text[:200]},
                metrics={"chars": len(text), "strategy": label},
                quiet=self.quiet))

        # Agreement checks; batched tiebreaker reads for pages that need one.
        tiebreak_plans: list[tuple[int, PreparedImage, str]] = []
        for index, state in enumerate(states):
            candidates = state["candidates"]
            if len(candidates) < 2:
                continue
            cmp = compare_versions(candidates[0]["text"], candidates[1]["text"])
            agreement = cmp["agreement_rate"]
            needs_tiebreak = agreement < state["config"]["agreement_threshold"]
            state["trace_events"].append(trace_log(
                state, iteration=0, agent="orchestrator", action="compare",
                input_summary="Comparing candidate 1 vs 2",
                output_summary=f"Versions agree {agreement}%",
                full_output=cmp, metrics={"agreement_rate": agreement},
                decision="tiebreaker" if needs_tiebreak else "merge",
                quiet=self.quiet))
            strategies = list(state["config"]["strategies"])
            if needs_tiebreak and len(strategies) > 2:
                label = strategy_label(strategies[2])
                if label not in state["strategies_used"]:
                    prepared = self.preprocessor.apply(state["image_path"],
                                                       strategies[2])
                    tiebreak_plans.append((index, prepared, label))
                    state["strategies_used"].append(label)
                    state["trace_events"].append(trace_log(
                        state, iteration=0, agent="reader", action="preprocess",
                        input_summary=f"Image: {state['image_path']}",
                        output_summary=f"Preprocessed with '{label}'",
                        metrics={"strategy": label}, quiet=self.quiet))

        if tiebreak_plans:
            texts = self._read(
                [img for _, img, _ in tiebreak_plans],
                [states[index] for index, _, _ in tiebreak_plans])
            for (index, _, label), text in zip(tiebreak_plans, texts):
                state = states[index]
                state["candidates"].append({
                    "text": text, "source": f"ocr_{label}",
                    "ocr_params": {"strategy": label}, "score": None})
                state["trace_events"].append(trace_log(
                    state, iteration=0, agent="reader", action="ocr",
                    input_summary=f"Preprocessed image ({label})",
                    output_summary=f"OCR pass ({label}) → {len(text)} chars",
                    full_output={"text_preview": text[:200]},
                    metrics={"chars": len(text), "strategy": label},
                    quiet=self.quiet))

        for state in states:
            merged = merge_versions([c["text"] for c in state["candidates"]])
            state["current_best"] = merged
            state["trace_events"].append(trace_log(
                state, iteration=0, agent="orchestrator", action="merge",
                input_summary=f"Merging {len(state['candidates'])} candidates",
                output_summary=f"Merged → {len(merged)} chars",
                metrics={"merged_chars": len(merged)}, quiet=self.quiet))
        self.ocr.release()

    def _read(self, images, image_states) -> list[str]:
        """Batched OCR reads honoring each page's OWN config: reads are
        grouped by (ocr_prompt, ocr_max_new_tokens) and each group runs
        as one ``read_batch`` — heterogeneous per-page configs no longer
        silently inherit page 0's prompt/budget."""
        if not images:
            return []
        assert len(images) == len(image_states)
        groups: dict[tuple[str, int], list[int]] = {}
        for i, state in enumerate(image_states):
            config = state["config"]
            prompt = config.get("ocr_prompt") or _cfg().OCR_PROMPT
            max_new = (config.get("ocr_max_new_tokens")
                       or _cfg().OCR_MAX_NEW_TOKENS)
            groups.setdefault((prompt, max_new), []).append(i)
        texts: list[str] = [""] * len(images)
        for (prompt, max_new), idxs in groups.items():
            out = self.ocr.read_batch([images[i] for i in idxs],
                                      prompt, max_new)
            for i, text in zip(idxs, out):
                texts[i] = text
        return texts

    # ── lockstep loop ─────────────────────────────────────────────
    def run_many(self, states: Sequence[OCRState]) -> list[OCRState]:
        states = [dict(s) for s in states]
        self._initial_ocr_all(states)

        cursors = ["critic"] * len(states)
        max_rounds = 4 * max(s["max_iterations"] for s in states) + 8
        for _ in range(max_rounds):
            if all(c == "__end__" for c in cursors):
                break
            # Snapshot: every page advances exactly one node per round
            # (no group starves behind another group's loop).
            snapshot = list(cursors)

            for i, node in enumerate(snapshot):
                if node in ("accept", "plateau", "max_iterations"):
                    method = {"accept": self._solo.node_accept,
                              "plateau": self._solo.node_plateau,
                              "max_iterations": self._solo.node_max_iter}[node]
                    states[i].update(method(states[i]))
                    cursors[i] = "__end__"

            critic_ids = [i for i, n in enumerate(snapshot) if n == "critic"]
            if critic_ids:
                self._critic_round(states, critic_ids)
                for i in critic_ids:
                    nxt = route_after_critic(states[i])
                    cursors[i] = "editor" if nxt == "edit" else nxt

            editor_ids = [i for i, n in enumerate(snapshot) if n == "editor"]
            if editor_ids:
                self._editor_round(states, editor_ids)
                for i in editor_ids:
                    cursors[i] = "critic"

            reocr_ids = [i for i, n in enumerate(snapshot) if n == "reocr"]
            if reocr_ids:
                self._reocr_round(states, reocr_ids)
                for i in reocr_ids:
                    cursors[i] = route_after_reocr(states[i])
        return states  # type: ignore[return-value]

    def _critic_round(self, states, ids) -> None:
        requests = []
        for i in ids:
            state = states[i]
            prev = None
            if state["prev_critique"]:
                try:
                    prev = CriticResult.validate(state["prev_critique"])
                except Exception:
                    prev = None
            requests.append(critic_request(state["current_best"], prev))
        raws = call_llm_json_batch(
            self.llm, requests, quiet=self.quiet,
            max_tokens=states[ids[0]]["config"].get("llm_max_tokens"))
        for i, raw in zip(ids, raws):
            state = states[i]
            critique = parse_critic(raw, quiet=self.quiet)
            update = self._apply_critic(state, critique)
            state.update(update)

    def _apply_critic(self, state, critique) -> dict:
        iteration = state["iteration"] + 1
        confidence = critique.overall_confidence
        all_issues = [iss for seg in critique.segments for iss in seg.issues]
        n_critical = sum(1 for s in all_issues if s.severity == "critical")
        n_minor = sum(1 for s in all_issues if s.severity == "minor")
        n_cosmetic = len(all_issues) - n_critical - n_minor
        trace = trace_log(
            state, iteration=iteration, agent="critic", action="critique",
            input_summary=f"Transcription ({len(state['current_best'])} chars)",
            output_summary=(
                f"Critic: confidence {confidence}, verdict={critique.verdict} "
                f"({len(all_issues)} issues: {n_critical} critical, "
                f"{n_minor} minor, {n_cosmetic} cosmetic)"),
            full_input={"transcription": state["current_best"]},
            full_output=critique.dump(),
            metrics={"confidence": confidence, "n_issues": len(all_issues),
                     "n_critical": n_critical, "n_minor": n_minor,
                     "n_cosmetic": n_cosmetic},
            decision=critique.verdict, quiet=self.quiet)
        plateau = state["plateau_count"] + 1 \
            if confidence <= state["prev_score"] else 0
        return {
            "iteration": iteration,
            "critiques": state["critiques"] + [critique.dump()],
            "current_score": confidence,
            "plateau_count": plateau,
            "prev_score": confidence,
            "trace_events": state["trace_events"] + [trace],
        }

    def _editor_round(self, states, ids) -> None:
        requests, critiques = [], []
        for i in ids:
            state = states[i]
            critique = CriticResult.validate(state["critiques"][-1])
            critiques.append(critique)
            requests.append(editor_request(state["current_best"], critique))
        raws = call_llm_json_batch(
            self.llm, requests, quiet=self.quiet,
            max_tokens=states[ids[0]]["config"].get("llm_max_tokens"))
        for i, raw, critique in zip(ids, raws, critiques):
            state = states[i]
            result = parse_editor(raw, state["current_best"], quiet=self.quiet)
            n_issues = sum(len(seg.issues) for seg in critique.segments)
            trace = trace_log(
                state, iteration=state["iteration"], agent="editor",
                action="edit",
                input_summary=f"Transcription + {n_issues} critic issues",
                output_summary=(f"Editor: fixed {len(result.changes)} issues, "
                                f"{len(result.unresolved)} unresolved"),
                full_input={"transcription": state["current_best"],
                            "critique": state["critiques"][-1]},
                full_output=result.dump(),
                metrics={"changes_made": len(result.changes),
                         "unresolved": len(result.unresolved)},
                quiet=self.quiet)
            state.update({
                "current_best": result.corrected_text,
                "edits": state["edits"] + [result.dump()],
                "prev_critique": state["critiques"][-1],
                "trace_events": state["trace_events"] + [trace],
            })

    def _reocr_round(self, states, ids) -> None:
        plans = []   # (page_idx, prepared, label)
        for i in ids:
            state = states[i]
            next_strategy = next(
                (s for s in state["config"]["strategies"]
                 if strategy_label(s) not in state["strategies_used"]), None)
            if next_strategy is None:
                state["reason"] = "exhausted"
                continue
            label = strategy_label(next_strategy)
            prepared = self.preprocessor.apply(state["image_path"], next_strategy)
            state["strategies_used"] = state["strategies_used"] + [label]
            state["trace_events"].append(trace_log(
                state, iteration=state["iteration"], agent="reader",
                action="preprocess",
                input_summary=f"Image: {state['image_path']}",
                output_summary=f"Preprocessed with '{label}'",
                metrics={"strategy": label}, quiet=self.quiet))
            plans.append((i, prepared, label))

        texts = self._read([p for _, p, _ in plans],
                           [states[i] for i, _, _ in plans])
        versions_by_page = {}
        for (i, _, label), text in zip(plans, texts):
            state = states[i]
            state["candidates"] = state["candidates"] + [{
                "text": text, "source": f"ocr_{label}",
                "ocr_params": {"strategy": label}, "score": None}]
            state["trace_events"].append(trace_log(
                state, iteration=state["iteration"], agent="reader",
                action="ocr",
                input_summary=f"Preprocessed image ({label})",
                output_summary=f"OCR pass ({label}) → {len(text)} chars",
                full_output={"text_preview": text[:200]},
                metrics={"chars": len(text), "strategy": label},
                quiet=self.quiet))
            versions_by_page[i] = [
                {"text": state["current_best"], "source": "current_best",
                 "score": state["current_score"]},
                {"text": text, "source": f"ocr_{label}"},
            ]
        if plans:
            self.ocr.release()

        arb_ids = list(versions_by_page)
        requests = [arbitrator_request(versions_by_page[i]) for i in arb_ids]
        raws = call_llm_json_batch(
            self.llm, requests, quiet=self.quiet,
            max_tokens=states[arb_ids[0]]["config"].get("llm_max_tokens")) \
            if requests else []
        for i, raw in zip(arb_ids, raws):
            state = states[i]
            result = parse_arbitrator(raw, versions_by_page[i], quiet=self.quiet)
            new_source = versions_by_page[i][1]["source"]
            state["trace_events"].append(trace_log(
                state, iteration=state["iteration"], agent="arbitrator",
                action="arbitrate",
                input_summary=f"Current best vs {new_source}",
                output_summary=(
                    f"Arbitrator: merged with confidence {result.confidence}, "
                    f"{len(result.uncertain_segments)} uncertain segments"),
                full_output=result.dump(),
                metrics={"confidence": result.confidence,
                         "n_decisions": len(result.decisions),
                         "n_uncertain": len(result.uncertain_segments)},
                quiet=self.quiet))
            state.update({
                "current_best": result.final_text,
                "prev_critique": state["critiques"][-1]
                if state["critiques"] else None,
            })


def _cfg():
    from handwritten_ocr_tpu_torch import config
    return config
