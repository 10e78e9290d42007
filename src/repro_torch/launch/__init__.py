"""Launchers of the port (single-card serving so far)."""
