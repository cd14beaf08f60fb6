"""Serving of the port: the SSSP serving plane (``queries``, ``registry``,
``scheduler``, ``router``, ``sssp_service``) and the LM continuous-batching
engine (``engine``)."""
