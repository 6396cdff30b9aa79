"""Scheduler side of the port: chunked pipeline and schedule_items."""
