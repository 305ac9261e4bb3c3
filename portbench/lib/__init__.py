"""Shared machinery of the benchmark: registry, run loop, tracing, guards."""
