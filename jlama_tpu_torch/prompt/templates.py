"""Chat-template rendering and the prompt builder (counterpart of
`jlama_tpu/prompt/templates.py`).

Templates render through `_jinja.py`, a renderer of the subset of Jinja that
chat templates use, held to the JAX package's jinja2 environment
(`trim_blocks`, `lstrip_blocks`, loop controls, `raise_exception`, `tojson`,
`strftime_now`); a construct outside it raises `TemplateError`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

from ._jinja import TemplateError, render
from .tools import PromptContext, Tool, ToolCall, ToolResult


def render_chat_template(
    template: str,
    messages: list[dict[str, Any]],
    *,
    tools: list[dict] | None = None,
    add_generation_prompt: bool = True,
    bos_token: str = "",
    eos_token: str = "",
    extra: dict | None = None,
) -> str:
    ctx = {
        "messages": messages,
        "add_generation_prompt": add_generation_prompt,
        "bos_token": bos_token,
        "eos_token": eos_token,
    }
    if tools is not None:
        ctx["tools"] = tools
    if extra:
        ctx.update(extra)
    return render(template, ctx)


@dataclass
class PromptBuilder:
    """Fluent chat builder."""

    spec: Any  # TokenizerSpec (duck-typed: template_for/bos_token/eos_token)
    messages: list[dict] = field(default_factory=list)
    tools: list[Tool] = field(default_factory=list)
    add_generation_prompt: bool = True

    def add_system(self, content: str) -> "PromptBuilder":
        self.messages.append({"role": "system", "content": content})
        return self

    def add_user(self, content: str) -> "PromptBuilder":
        self.messages.append({"role": "user", "content": content})
        return self

    def add_assistant(self, content: str) -> "PromptBuilder":
        self.messages.append({"role": "assistant", "content": content})
        return self

    def add_tool_call(self, call: ToolCall) -> "PromptBuilder":
        self.messages.append(
            {"role": "assistant", "tool_calls": [call.to_dict()], "content": ""}
        )
        return self

    def add_tool_result(self, result: ToolResult) -> "PromptBuilder":
        self.messages.append(
            {
                "role": "tool",
                "content": json.dumps({"result": result.result}),
                "name": result.name,
                "tool_call_id": result.tool_call_id,
            }
        )
        return self

    def add_tools(self, *tools: Tool) -> "PromptBuilder":
        self.tools.extend(tools)
        return self

    def build(self) -> PromptContext:
        template_name = "tool_use" if self.tools else "default"
        template = None
        if self.spec is not None:
            template = self.spec.template_for(template_name)
        if template is None:
            # no template: plain role-prefixed text
            parts = [f"{m['role']}: {m.get('content','')}" for m in self.messages]
            if self.add_generation_prompt:
                parts.append("assistant: ")
            return PromptContext("\n".join(parts), self.tools or None)
        rendered = render_chat_template(
            template,
            self.messages,
            tools=[t.to_dict() for t in self.tools] if self.tools else None,
            add_generation_prompt=self.add_generation_prompt,
            bos_token=self.spec.bos_token or "",
            eos_token=self.spec.eos_token or "",
        )
        return PromptContext(rendered, self.tools or None)
