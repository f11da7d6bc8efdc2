"""Host-side utilities: the program's spans and counters, section timers and
profiler traces."""
