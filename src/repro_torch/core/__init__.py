"""Core engine of the port: graph layouts, heuristics, relaxation, solve."""
