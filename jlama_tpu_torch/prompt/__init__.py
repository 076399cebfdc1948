"""Chat templates, tool schemas and tool-call extraction (counterpart of
`jlama_tpu.prompt`), in the standard library only."""

from .tools import (
    Function,
    Parameters,
    PromptContext,
    Tool,
    ToolCall,
    ToolResult,
)
from .templates import PromptBuilder, render_chat_template, TemplateError
from .toolcall_parse import extract_tool_calls

__all__ = [
    "Function",
    "Parameters",
    "PromptContext",
    "Tool",
    "ToolCall",
    "ToolResult",
    "PromptBuilder",
    "render_chat_template",
    "TemplateError",
    "extract_tool_calls",
]
