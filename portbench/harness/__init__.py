"""The yardstick shared by every cell: discovery by name, the step clock,
the profiler capture and its reduction, the comparison that decides
``correct``, the operation and byte counts, the peaks, the weights made
from the seed and the check of the modules a run loaded."""
