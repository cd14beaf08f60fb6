"""Model code of the port: the dense decoder-only LM (``transformer``),
its building blocks (``layers``) and the recsys models (``recsys``)."""
