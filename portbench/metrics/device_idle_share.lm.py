"""Percent of the capture's span (first device event to last) in which
no operation ran on the card: 100 x (1 - the union of the device events'
intervals / the span)."""

from portbench.harness.readers import idle_share


def read(facts):
    return idle_share(facts["trace"])
