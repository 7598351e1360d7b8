"""Per-task preprocessors (registry extension point ``get_preprocessor``)."""
