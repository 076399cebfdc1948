"""Tool-call extraction from generated text (a copy of
`jlama_tpu/prompt/toolcall_parse.py`): scan the output for JSON blocks that
name a known tool, parse arguments, dedupe, and assign 9-digit ids.
"""

from __future__ import annotations

import json
import random
import re

from .tools import Tool, ToolCall

_JSON_BLOCK = re.compile(r"\{(?:[^{}]|\{(?:[^{}]|\{[^{}]*\})*\})*\}", re.DOTALL)


def _candidate_jsons(text: str) -> list[dict]:
    out = []
    for m in _JSON_BLOCK.finditer(text):
        try:
            obj = json.loads(m.group())
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict):
            out.append(obj)
    return out


def extract_tool_calls(text: str, tools: list[Tool]) -> list[ToolCall]:
    """Find tool invocations in model output. Empty list = no tool call."""
    names = {t.function.name for t in tools}
    calls: list[ToolCall] = []
    seen: set[tuple] = set()
    for obj in _candidate_jsons(text):
        name = obj.get("name")
        if name not in names:
            fn = obj.get("function")
            if isinstance(fn, dict) and fn.get("name") in names:
                name = fn["name"]
                obj = fn
            else:
                continue
        args = obj.get("parameters", obj.get("arguments", {}))
        if isinstance(args, str):
            try:
                args = json.loads(args)
            except json.JSONDecodeError:
                args = {"raw": args}
        key = (name, json.dumps(args, sort_keys=True))
        if key in seen:
            continue
        seen.add(key)
        calls.append(
            ToolCall(name=name, parameters=args, id=f"{random.randint(0, 999999999):09d}")
        )
    return calls
