"""The plain reference and the comparison that decides ``correct``.

Plain PyTorch over the harness's raw undirected edge list: nothing of the
port is imported, and nothing the port made (its CSR, layout, tables or
state) is read, except the outputs it is judging.
"""
