"""Utilities (resource quantities)."""
