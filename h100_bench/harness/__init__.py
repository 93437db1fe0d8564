"""The benchmark's harness: its data lookup, traffic drivers, spans and
trace reduction, the yardstick's counters, and the check."""
