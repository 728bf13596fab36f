"""Completion models of the port (the offline stub)."""
