"""Visualizers (registry extension point ``get_visualizer``)."""
