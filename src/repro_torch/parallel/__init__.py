"""Many-device rules of the port: sharding placements and gradient
compression, as ``repro.parallel``."""
