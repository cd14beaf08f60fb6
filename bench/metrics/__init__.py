"""Per-layer metric readers: ``<metric>.py`` holds ``read(t)``, which takes
a :class:`bench.trace.TraceData` and returns the metric's value, or None
when the traced run holds nothing to read.  ``_work.py`` holds the counts
of work that readers and the harness share."""
