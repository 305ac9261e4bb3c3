"""Frozen analytic counts, peaks and roofline arithmetic of the benchmark."""
