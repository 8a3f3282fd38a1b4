"""Host ms a step in the Trainer's own ``fetch`` span: the next batch
from ``data.prefetch_to_device`` (the host gather and the dispatch of its
copy), over the window's steps."""

from portbench.harness.readers import span_ms


def read(facts):
    return span_ms(facts["spans"], "fetch")
