"""Drivers: one general loop per kind of traffic, found by name."""
