"""Host-side utilities (section timers, profiler annotations and traces)."""
