"""Host ms a step in the harness's span around the step call, over the
window's steps (the CLI's loop has no span of its own). When the card
paces the loop the launch queue's back-pressure lands here too."""

from portbench.harness.readers import span_ms


def read(facts):
    return span_ms(facts["spans"], "dispatch")
