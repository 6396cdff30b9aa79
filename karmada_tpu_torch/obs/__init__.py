"""Observability of the port: the explain plane's Decision records."""
