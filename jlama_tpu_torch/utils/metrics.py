"""Serving metrics (counterpart of `jlama_tpu/utils/metrics.py`): p50/p95
time to first token and decode tokens/s over finished responses. The
scheduler records every finished request in `GLOBAL_METRICS`."""

from __future__ import annotations

import statistics
import threading
from dataclasses import dataclass, field


@dataclass
class ServingMetrics:
    ttft_ms: list[float] = field(default_factory=list)
    decode_tok_s: list[float] = field(default_factory=list)
    prompt_tokens: int = 0
    generated_tokens: int = 0
    requests: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def record(self, resp) -> None:
        """Record a Response."""
        with self._lock:
            self.requests += 1
            self.prompt_tokens += resp.prompt_tokens
            self.generated_tokens += resp.generated_tokens
            self.ttft_ms.append(resp.prompt_time_ms)
            if resp.generate_time_ms > 0 and resp.generated_tokens > 0:
                self.decode_tok_s.append(
                    resp.generated_tokens / (resp.generate_time_ms / 1000)
                )
            # bound memory
            if len(self.ttft_ms) > 10000:
                del self.ttft_ms[:5000]
            if len(self.decode_tok_s) > 10000:
                del self.decode_tok_s[:5000]

    def snapshot(self) -> dict:
        with self._lock:
            def pct(xs, p):
                if not xs:
                    return None
                return float(statistics.quantiles(xs, n=100)[p - 1]) if len(xs) > 1 else xs[0]

            return {
                "requests": self.requests,
                "prompt_tokens": self.prompt_tokens,
                "generated_tokens": self.generated_tokens,
                "p50_ttft_ms": pct(self.ttft_ms, 50),
                "p95_ttft_ms": pct(self.ttft_ms, 95),
                "p50_decode_tok_s": pct(self.decode_tok_s, 50),
            }


GLOBAL_METRICS = ServingMetrics()
