"""The OpenAI-compatible HTTP server (counterpart of `jlama_tpu.server`)."""

from .openai_api import OpenAIServer

__all__ = ["OpenAIServer"]
