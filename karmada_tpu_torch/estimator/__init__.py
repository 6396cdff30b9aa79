"""Capacity estimation (scheduler side)."""
