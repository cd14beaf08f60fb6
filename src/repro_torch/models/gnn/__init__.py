"""The GNN models of the port (GIN, GatedGCN, PNA, DimeNet) over the
shared segment message passing of ``common`` and ``sharded_ops``, each
the counterpart of ``repro.models.gnn.<name>``."""
