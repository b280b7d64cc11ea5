"""Workload configs and the port's checkpoint format."""
