"""Data of the port: graph generators (``generators``) and synthetic
recsys traffic (``synthetic``)."""
