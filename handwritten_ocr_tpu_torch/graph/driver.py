"""The pipeline driver: node implementations + the graph execution loop
(port of ``handwritten_ocr_tpu/graph/driver.py``).

Node semantics, edges, routing and trace events are the JAX package's;
the agents' contracts are the port's plain classes (``validate`` /
``dump`` in place of pydantic's ``model_validate`` / ``model_dump``). The
initial multi-strategy reads are one batched VLM call (``read_batch``);
trace events still record each logical pass in order.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Sequence

from handwritten_ocr_tpu_torch.agents.runners import (run_arbitrator,
                                                      run_critic, run_editor)
from handwritten_ocr_tpu_torch.agents.schemas import CriticResult
from handwritten_ocr_tpu_torch.engine.llm_client import ReasoningBackend
from handwritten_ocr_tpu_torch.engine.protocols import (OCRBackend,
                                                        PreparedImage,
                                                        Preprocessor,
                                                        strategy_label)
from handwritten_ocr_tpu_torch.graph.routing import (route_after_critic,
                                                     route_after_reocr)
from handwritten_ocr_tpu_torch.state import OCRState, trace_log
from handwritten_ocr_tpu_torch.text.diff import compare_versions
from handwritten_ocr_tpu_torch.text.merge import merge_versions

_END = "__end__"


class _PassthroughPreprocessor:
    """Default preprocessor: hands the raw path to the backend unchanged."""

    def apply(self, image_path: str, strategy: str | Sequence[str]) -> PreparedImage:
        return PreparedImage(data=image_path,
                             strategy_label=strategy_label(strategy),
                             source_path=image_path)


class OCRPipeline:
    """Drives one page through initial OCR → critique/edit/re-OCR → terminal.

    Parameters
    ----------
    ocr : OCRBackend — the VLM engine.
    llm : ReasoningBackend — the critic/editor/arbitrator engine.
    preprocessor : Preprocessor — image transform bank (defaults to passthrough).
    quiet : silence console chatter (batch mode runs many pages).
    """

    def __init__(
        self,
        ocr: OCRBackend,
        llm: ReasoningBackend,
        preprocessor: Preprocessor | None = None,
        quiet: bool = False,
    ) -> None:
        self.ocr = ocr
        self.llm = llm
        self.preprocessor = preprocessor or _PassthroughPreprocessor()
        self.quiet = quiet

    # ── graph topology ────────────────────────────────────────────
    def run(self, state: OCRState,
            snapshot_path: str | None = None,
            resume: bool = False) -> OCRState:
        """Execute the graph to completion; returns the final state.

        With ``snapshot_path``, the full pipeline state is written
        after every node, and ``resume=True`` continues a crashed run from
        the last completed node instead of redoing the page.
        """
        nodes: dict[str, Callable[[OCRState], dict]] = {
            "initial_ocr": self.node_initial_ocr,
            "critic": self.node_critic,
            "editor": self.node_editor,
            "reocr": self.node_reocr,
            "accept": self.node_accept,
            "plateau": self.node_plateau,
            "max_iterations": self.node_max_iter,
        }
        static_edges = {
            "initial_ocr": "critic",
            "editor": "critic",
            "accept": _END,
            "plateau": _END,
            "max_iterations": _END,
        }

        state = dict(state)  # value-passed; never mutate the caller's dict
        current = "initial_ocr"

        if resume and snapshot_path and Path(snapshot_path).exists():
            saved = json.loads(Path(snapshot_path).read_text(encoding="utf-8"))
            state = saved["state"]
            current = saved["next_node"]
            self._say(f"  [resume] Continuing from node '{current}' "
                      f"(iteration {state['iteration']})")
            if current == _END:
                return state  # type: ignore[return-value]

        # Safety bound: each iteration visits at most critic+editor/reocr,
        # plus initial + terminal. Generous cap to catch routing bugs.
        for _ in range(4 * state["max_iterations"] + 8):
            update = nodes[current](state)  # type: ignore[arg-type]
            state.update(update)
            if current == "critic":
                nxt = route_after_critic(state)  # type: ignore[arg-type]
                current = "editor" if nxt == "edit" else nxt
            elif current == "reocr":
                current = route_after_reocr(state)  # type: ignore[arg-type]
            else:
                current = static_edges[current]
            if snapshot_path:
                Path(snapshot_path).write_text(
                    json.dumps({"next_node": current, "state": state}),
                    encoding="utf-8")
            if current == _END:
                if snapshot_path:
                    Path(snapshot_path).unlink(missing_ok=True)
                return state  # type: ignore[return-value]
        raise RuntimeError("pipeline did not reach a terminal node (routing bug)")

    # ── helpers ───────────────────────────────────────────────────
    def _say(self, message: str) -> None:
        if not self.quiet:
            print(message)

    def _ocr_passes(
        self,
        state: OCRState,
        strategies: list[str | Sequence[str]],
        candidates: list[dict],
        strategies_used: list[str],
        trace_events: list[dict],
        iteration: int = 0,
    ) -> None:
        """Run OCR over every not-yet-used strategy as ONE batched forward.

        Per pass: label dedup, candidate dict shape, and the preprocess +
        ocr trace events **interleaved per pass** (preprocess, ocr,
        preprocess, ocr); all passes share one batched ``read_batch``
        call, so the preprocess events are buffered at prepare time and
        spliced into per-pass order once the batched read returns.
        """
        fresh: list[tuple[str, str | Sequence[str]]] = []
        for strat in strategies:
            label = strategy_label(strat)
            if label in strategies_used or label in [f[0] for f in fresh]:
                continue
            fresh.append((label, strat))
        if not fresh:
            return

        prepared: list[PreparedImage] = []
        preprocess_events: list[dict] = []
        for label, strat in fresh:
            strategies_used.append(label)
            prepared.append(self.preprocessor.apply(state["image_path"], strat))
            preprocess_events.append(trace_log(
                state,
                iteration=iteration,
                agent="reader",
                action="preprocess",
                input_summary=f"Image: {state['image_path']}",
                output_summary=f"Preprocessed with '{label}'",
                metrics={"strategy": label},
                quiet=self.quiet,
            ))

        prompt = state["config"].get("ocr_prompt") or _default_prompt()
        max_new = state["config"].get("ocr_max_new_tokens") or _default_max_new_tokens()
        texts = self.ocr.read_batch(prepared, prompt, max_new)

        for (label, _), text, pre_event in zip(fresh, texts, preprocess_events):
            candidates.append({
                "text": text,
                "source": f"ocr_{label}",
                "ocr_params": {"strategy": label},
                "score": None,
            })
            trace_events.append(pre_event)
            trace_events.append(trace_log(
                state,
                iteration=iteration,
                agent="reader",
                action="ocr",
                input_summary=f"Preprocessed image ({label})",
                output_summary=f"OCR pass ({label}) → {len(text)} chars",
                full_output={"text_preview": text[:200]},
                metrics={"chars": len(text), "strategy": label},
                quiet=self.quiet,
            ))

    # ── nodes ─────────────────────────────────────────────────────
    def node_initial_ocr(self, state: OCRState) -> dict:
        """Phase 1: batched multi-strategy reads, agreement check, merge."""
        self._say("\n=== PHASE 1: Initial OCR Reads ===")

        strategy_list = list(state["config"]["strategies"])
        candidates = list(state["candidates"])
        strategies_used = list(state["strategies_used"])
        trace_events: list[dict] = []

        initial = strategy_list[:2] if strategy_list else ["original"]
        self._ocr_passes(state, initial, candidates, strategies_used, trace_events)

        if len(candidates) >= 2:
            cmp = compare_versions(candidates[0]["text"], candidates[1]["text"])
            agreement = cmp["agreement_rate"]
            needs_tiebreak = agreement < state["config"]["agreement_threshold"]
            trace_events.append(trace_log(
                state,
                iteration=0,
                agent="orchestrator",
                action="compare",
                input_summary="Comparing candidate 1 vs 2",
                output_summary=f"Versions agree {agreement}%",
                full_output=cmp,
                metrics={"agreement_rate": agreement},
                decision="tiebreaker" if needs_tiebreak else "merge",
                quiet=self.quiet,
            ))
            if needs_tiebreak and len(strategy_list) > 2:
                self._ocr_passes(state, [strategy_list[2]], candidates,
                                 strategies_used, trace_events)

        current_best = merge_versions([c["text"] for c in candidates])
        trace_events.append(trace_log(
            state,
            iteration=0,
            agent="orchestrator",
            action="merge",
            input_summary=f"Merging {len(candidates)} candidates",
            output_summary=f"Merged → {len(current_best)} chars",
            metrics={"merged_chars": len(current_best)},
            quiet=self.quiet,
        ))

        # Unload hook of the OCRBackend protocol; a no-op for the resident
        # torch engine.
        self.ocr.release()

        return {
            "candidates": candidates,
            "current_best": current_best,
            "strategies_used": strategies_used,
            "trace_events": state["trace_events"] + trace_events,
        }

    def node_critic(self, state: OCRState) -> dict:
        """Run the critic; update score and plateau tracking."""
        iteration = state["iteration"] + 1
        if iteration == 1:
            self._say("\n=== PHASE 2: Critique-Edit Loop ===")
        self._say(f"\n--- Iteration {iteration} ---")

        prev_critique = None
        if state["prev_critique"]:
            try:
                prev_critique = CriticResult.validate(state["prev_critique"])
            except Exception:
                prev_critique = None

        critique = run_critic(self.llm, state["current_best"],
                              previous_critique=prev_critique, quiet=self.quiet,
                              max_tokens=state["config"].get("llm_max_tokens"))
        critiques = list(state["critiques"]) + [critique.dump()]

        confidence = critique.overall_confidence
        all_issues = [issue for seg in critique.segments for issue in seg.issues]
        n_issues = len(all_issues)
        n_critical = sum(1 for i in all_issues if i.severity == "critical")
        n_minor = sum(1 for i in all_issues if i.severity == "minor")
        n_cosmetic = n_issues - n_critical - n_minor

        trace_events = [trace_log(
            state,
            iteration=iteration,
            agent="critic",
            action="critique",
            input_summary=f"Transcription ({len(state['current_best'])} chars)",
            output_summary=(
                f"Critic: confidence {confidence}, verdict={critique.verdict} "
                f"({n_issues} issues: {n_critical} critical, {n_minor} minor, "
                f"{n_cosmetic} cosmetic)"
            ),
            full_input={"transcription": state["current_best"]},
            full_output=critique.dump(),
            metrics={
                "confidence": confidence,
                "n_issues": n_issues,
                "n_critical": n_critical,
                "n_minor": n_minor,
                "n_cosmetic": n_cosmetic,
            },
            decision=critique.verdict,
            quiet=self.quiet,
        )]

        # Plateau: an equal score counts as no-improvement.
        plateau_count = state["plateau_count"] + 1 if confidence <= state["prev_score"] else 0

        return {
            "iteration": iteration,
            "critiques": critiques,
            "current_score": confidence,
            "plateau_count": plateau_count,
            "prev_score": confidence,
            "trace_events": state["trace_events"] + trace_events,
        }

    def node_editor(self, state: OCRState) -> dict:
        """Run the editor on critic findings."""
        latest_critique_dict = state["critiques"][-1]
        critique = CriticResult.validate(latest_critique_dict)
        n_issues = sum(len(seg.issues) for seg in critique.segments)

        edit_result = run_editor(self.llm, state["current_best"], critique,
                                 quiet=self.quiet,
                                 max_tokens=state["config"].get("llm_max_tokens"))
        edits = list(state["edits"]) + [edit_result.dump()]

        trace_events = [trace_log(
            state,
            iteration=state["iteration"],
            agent="editor",
            action="edit",
            input_summary=f"Transcription + {n_issues} critic issues",
            output_summary=(
                f"Editor: fixed {len(edit_result.changes)} issues, "
                f"{len(edit_result.unresolved)} unresolved"
            ),
            full_input={"transcription": state["current_best"],
                        "critique": latest_critique_dict},
            full_output=edit_result.dump(),
            metrics={"changes_made": len(edit_result.changes),
                     "unresolved": len(edit_result.unresolved)},
            quiet=self.quiet,
        )]

        return {
            "current_best": edit_result.corrected_text,
            "edits": edits,
            "prev_critique": latest_critique_dict,
            "trace_events": state["trace_events"] + trace_events,
        }

    def node_reocr(self, state: OCRState) -> dict:
        """Re-OCR with the next unused strategy, then arbitrate."""
        strategy_list = list(state["config"]["strategies"])
        strategies_used = list(state["strategies_used"])
        candidates = list(state["candidates"])
        trace_events: list[dict] = []

        next_strategy = next(
            (s for s in strategy_list if strategy_label(s) not in strategies_used),
            None,
        )
        if next_strategy is None:
            return {"reason": "exhausted", "trace_events": state["trace_events"]}

        self._say(f"\n--- Re-OCR with strategy: {strategy_label(next_strategy)} ---")
        self._ocr_passes(state, [next_strategy], candidates, strategies_used,
                         trace_events, iteration=state["iteration"])
        self.ocr.release()

        new_candidate = candidates[-1]
        versions = [
            {"text": state["current_best"], "source": "current_best",
             "score": state["current_score"]},
            {"text": new_candidate["text"], "source": new_candidate["source"]},
        ]
        arb_result = run_arbitrator(self.llm, versions, quiet=self.quiet,
                                    max_tokens=state["config"].get("llm_max_tokens"))

        trace_events.append(trace_log(
            state,
            iteration=state["iteration"],
            agent="arbitrator",
            action="arbitrate",
            input_summary=f"Current best vs {new_candidate['source']}",
            output_summary=(
                f"Arbitrator: merged with confidence {arb_result.confidence}, "
                f"{len(arb_result.uncertain_segments)} uncertain segments"
            ),
            full_output=arb_result.dump(),
            metrics={
                "confidence": arb_result.confidence,
                "n_decisions": len(arb_result.decisions),
                "n_uncertain": len(arb_result.uncertain_segments),
            },
            quiet=self.quiet,
        ))

        return {
            "current_best": arb_result.final_text,
            "candidates": candidates,
            "strategies_used": strategies_used,
            "prev_critique": state["critiques"][-1] if state["critiques"] else None,
            "trace_events": state["trace_events"] + trace_events,
        }

    # ── terminal nodes ────────────────────────────────────────────
    def node_accept(self, state: OCRState) -> dict:
        trace_events = [trace_log(
            state,
            iteration=state["iteration"],
            agent="orchestrator",
            action="accept",
            input_summary=(
                f"Confidence {state['current_score']} >= "
                f"{state['config']['accept_threshold']}"
            ),
            output_summary=(
                f"DONE — {state['iteration']} iterations, "
                f"final confidence {state['current_score']}"
            ),
            decision="accept",
            quiet=self.quiet,
        )]
        return {
            "status": "completed",
            "reason": "accept",
            "trace_events": state["trace_events"] + trace_events,
        }

    def node_plateau(self, state: OCRState) -> dict:
        trace_events = [trace_log(
            state,
            iteration=state["iteration"],
            agent="orchestrator",
            action="plateau",
            input_summary=(
                f"No improvement for {state['config']['plateau_patience']} iterations"
            ),
            output_summary=(
                f"DONE (plateau) — {state['iteration']} iterations, "
                f"final confidence {state['current_score']}"
            ),
            decision="plateau_stop",
            quiet=self.quiet,
        )]
        return {
            "status": "completed",
            "reason": "plateau",
            "trace_events": state["trace_events"] + trace_events,
        }

    def node_max_iter(self, state: OCRState) -> dict:
        reason = state.get("reason", "")
        if reason == "exhausted":
            action, decision = "strategies_exhausted", "exhausted_stop"
            input_summary = "All preprocessing strategies tried"
            summary = (
                f"DONE (strategies exhausted) — {state['iteration']} iterations, "
                f"final confidence {state['current_score']}"
            )
        else:
            action, decision = "max_iterations", "max_iterations_stop"
            input_summary = f"Reached {state['max_iterations']} iterations"
            summary = (
                f"DONE (max iterations) — {state['iteration']} iterations, "
                f"final confidence {state['current_score']}"
            )

        trace_events = [trace_log(
            state,
            iteration=state["iteration"],
            agent="orchestrator",
            action=action,
            input_summary=input_summary,
            output_summary=summary,
            decision=decision,
            quiet=self.quiet,
        )]
        return {
            "status": "max_iterations" if reason != "exhausted" else "completed",
            "reason": reason or "max_iterations",
            "trace_events": state["trace_events"] + trace_events,
        }


def _default_prompt() -> str:
    from handwritten_ocr_tpu_torch import config
    return config.OCR_PROMPT


def _default_max_new_tokens() -> int:
    from handwritten_ocr_tpu_torch import config
    return config.OCR_MAX_NEW_TOKENS
