"""Observability of the port: the explain plane's Decision records
(decisions) and the device's cost ledger, memory attribution and
profiler capture (devprof)."""
