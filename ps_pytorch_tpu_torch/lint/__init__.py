"""pslint on the port: only the consensus inventory so far
(``diverge.consensus_inventory``, which pscheck's PSC110 reads). The
rules PSL001-PSL008 and the CLI are ROADMAP.md item 24."""

from .diverge import consensus_inventory

__all__ = ["consensus_inventory"]
