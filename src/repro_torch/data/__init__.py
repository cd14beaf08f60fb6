"""Graph generators of the port."""
