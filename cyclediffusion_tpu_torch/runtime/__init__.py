"""Run-time layer: the experiment-config reader, the program registry, the
evaluation driver, profiling, and the shared scorer context."""
