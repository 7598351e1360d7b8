"""Measurement scripts for the port on the card (run with ``python -m``)."""
