"""Recsys models of the port: the embedding layer (``embedding``) and
MIND (``mind``)."""
