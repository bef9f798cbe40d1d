"""Measurement scripts for the port, run with ``python3 -m``."""
