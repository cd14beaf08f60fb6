"""Data of the port: graph generators and molecule batches
(``generators``), synthetic LM, recsys and GNN data (``synthetic``) and
DimeNet's triplet indices (``triplets``)."""
