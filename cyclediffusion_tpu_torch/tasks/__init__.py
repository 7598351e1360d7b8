"""Task models: what one evaluation sample runs through."""
