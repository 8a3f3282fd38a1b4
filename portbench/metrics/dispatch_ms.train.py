"""Host ms a step in the Trainer's own ``dispatch`` span (trainer.py),
over the window's steps. When the card paces the loop the launch queue
fills and its back-pressure lands in this span too."""

from portbench.harness.readers import span_ms


def read(facts):
    return span_ms(facts["spans"], "dispatch")
