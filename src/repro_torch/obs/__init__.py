"""Tracing for the deployment stack: spans, events and counters
(:mod:`.recorder`). Flow reports are not ported yet."""
from .recorder import (NULL_RECORDER, Recorder, Span,  # noqa: F401
                       maybe_span, read_jsonl)
