"""Robust JSON extraction from LLM completions.

Behavioral parity with the reference's three-strategy extractor
(reference scheduler.py:474-519):

1. fenced ```json ... ``` block (scheduler.py:477-485)
2. last balanced {...} object in the text (scheduler.py:487-501)
3. first balanced {...} object in the text (scheduler.py:503-517)

This implementation uses a proper string-aware brace scanner (the reference's
counter breaks on braces inside JSON strings) and is pure — no logging, no
side effects — so it is trivially unit-testable.

With the in-tree constrained JSON decoder (engine/constrained.py) the model
cannot emit malformed JSON, so this extractor is defense in depth for the
unconstrained sampling path, mirroring the reference's validate-then-fallback
posture (scheduler.py:453-465).
"""

from __future__ import annotations

import json
import re
from typing import Any

_FENCE_RE = re.compile(r"```(?:json)?\s*(\{.*?\})\s*```", re.DOTALL)


_DECODER = json.JSONDecoder()


def _decodable_objects(text: str) -> list[dict[str, Any]]:
    """All JSON objects decodable starting at some '{' in the text.

    Tries `raw_decode` at each '{' position; on success skips past the
    decoded span (so nested objects aren't re-reported), on failure moves to
    the next '{'. Unlike a brace-depth counter, a stray unmatched '{' in the
    model's prose before the real object cannot swallow it.
    """
    objects: list[dict[str, Any]] = []
    pos = 0
    while True:
        start = text.find("{", pos)
        if start == -1:
            return objects
        try:
            obj, end = _DECODER.raw_decode(text, start)
        except (json.JSONDecodeError, ValueError):
            pos = start + 1
            continue  # graftlint: ok[unbounded-retry] — cursor scan, not a retry: pos strictly advances so find() terminates
        if isinstance(obj, dict):
            objects.append(obj)
        pos = end


def _try_load(candidate: str) -> dict[str, Any] | None:
    try:
        obj = json.loads(candidate)
    except (json.JSONDecodeError, ValueError):
        return None
    return obj if isinstance(obj, dict) else None


def extract_json(text: str) -> dict[str, Any] | None:
    """Extract the most plausible JSON object from model output.

    Strategy order matches the reference (scheduler.py:474-519): fenced block
    first, then the last balanced object, then the first. Returns None when
    nothing parses.
    """
    if not text:
        return None

    for match in _FENCE_RE.finditer(text):
        obj = _try_load(match.group(1))
        if obj is not None:
            return obj

    objects = _decodable_objects(text)
    if objects:
        return objects[-1]  # last object first (scheduler.py:487-501)
    return None


def parse_decision_json(text: str) -> dict[str, Any] | None:
    """Extract and shape-check a scheduling decision object.

    The decision schema is {"selected_node": str, "confidence": number,
    "reasoning": str} (reference scheduler.py:196-214). Returns the dict with
    defaulted/coerced fields, or None if `selected_node` is absent.
    """
    obj = extract_json(text)
    if obj is None:
        return None
    node = obj.get("selected_node")
    if not isinstance(node, str) or not node:
        return None
    try:
        confidence = float(obj.get("confidence", 0.5))
    except (TypeError, ValueError):
        confidence = 0.5
    confidence = max(0.0, min(1.0, confidence))
    reasoning = obj.get("reasoning")
    if not isinstance(reasoning, str):
        reasoning = ""
    return {"selected_node": node, "confidence": confidence, "reasoning": reasoning}
