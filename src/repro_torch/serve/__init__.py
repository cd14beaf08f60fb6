"""Serving of the port: the LM continuous-batching engine."""
