"""Run-time helpers: the experiment-config reader and the shared scorer
context."""
