"""Loops: one general generator and timed loop per kind of traffic."""
