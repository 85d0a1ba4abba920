"""LLM agents: critic, editor, arbitrator (port of
``handwritten_ocr_tpu/agents``).

Each agent is one structured LLM call against a pluggable reasoning
backend (the torch Qwen3 engine, or a scripted fake for tests). Output
contracts are the plain classes of :mod:`.schemas`.
"""

from handwritten_ocr_tpu_torch.agents.runners import (run_arbitrator,
                                                      run_critic, run_editor)
from handwritten_ocr_tpu_torch.agents.schema_prompt import schema_example
from handwritten_ocr_tpu_torch.agents.schemas import (ArbitratorDecision,
                                                      ArbitratorResult,
                                                      CriticIssue,
                                                      CriticResult,
                                                      CriticSegment,
                                                      EditorChange,
                                                      EditorResult)

__all__ = [
    "CriticIssue",
    "CriticSegment",
    "CriticResult",
    "EditorChange",
    "EditorResult",
    "ArbitratorDecision",
    "ArbitratorResult",
    "schema_example",
    "run_critic",
    "run_editor",
    "run_arbitrator",
]
