"""Host utilities: stage timers, traces, FLOP and parameter counts
(profiling.py), and the native host-preprocessing library (native.py)."""
