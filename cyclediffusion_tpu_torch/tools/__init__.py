"""Measurement scripts for the port on the card (run with ``python -m``), and
the synthetic SD and LDM assets of ``sd_assets.py`` for tests and smoke runs."""
