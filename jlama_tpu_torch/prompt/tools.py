"""OpenAI-style function-tool schemas (a copy of `jlama_tpu/prompt/tools.py`):
builder-style schema objects serialized into chat templates and parsed back
from model output.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Parameters:
    properties: dict[str, dict[str, Any]] = field(default_factory=dict)
    required: list[str] = field(default_factory=list)
    type: str = "object"

    def add_property(self, name: str, ptype: str, description: str | None = None,
                     required: bool = True, **extra) -> "Parameters":
        prop = {"type": ptype, **extra}
        if description:
            prop["description"] = description
        self.properties[name] = prop
        if required and name not in self.required:
            self.required.append(name)
        return self

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "properties": self.properties,
            "required": self.required,
        }


@dataclass
class Function:
    name: str
    description: str | None = None
    parameters: Parameters = field(default_factory=Parameters)

    def to_dict(self) -> dict:
        d: dict = {"name": self.name, "parameters": self.parameters.to_dict()}
        if self.description:
            d["description"] = self.description
        return d


@dataclass
class Tool:
    function: Function
    type: str = "function"

    @staticmethod
    def from_function(fn: Function) -> "Tool":
        return Tool(function=fn)

    def to_dict(self) -> dict:
        return {"type": self.type, "function": self.function.to_dict()}


@dataclass
class ToolCall:
    name: str
    parameters: dict[str, Any] = field(default_factory=dict)
    id: str | None = None

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "type": "function",
            "function": {
                "name": self.name,
                "arguments": json.dumps(self.parameters),
            },
        }


@dataclass
class ToolResult:
    result: Any
    name: str | None = None
    tool_call_id: str | None = None

    def to_dict(self) -> dict:
        return {"content": json.dumps({"result": self.result}), "name": self.name}


@dataclass
class PromptContext:
    """A rendered prompt plus the tools it carries."""

    prompt: str
    tools: list[Tool] | None = None

    @staticmethod
    def of(prompt: str) -> "PromptContext":
        return PromptContext(prompt)

    @property
    def has_tools(self) -> bool:
        return bool(self.tools)
