"""Utilities: resource quantities, feature gates, well-known labels, the
out-of-process device probe and the serve policy (deviceprobe), leader
election over a store Lease (leaderelection)."""
