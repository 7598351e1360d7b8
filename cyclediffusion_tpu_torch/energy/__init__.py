"""Scoring of translated images: CLIP and directional CLIP."""
