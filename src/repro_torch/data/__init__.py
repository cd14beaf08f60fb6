"""Data of the port: graph generators and molecule batches
(``generators``), synthetic LM, recsys and GNN data (``synthetic``),
DimeNet's triplet indices (``triplets``), edge-weight variants
(``weights``), Zipf query traffic (``traffic``) and the GraphSAGE
neighbour sampler (``sampler``)."""
