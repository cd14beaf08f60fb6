"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and prints
one JSON line.  Everything a cell needs is found by name:

* ``bench/configs/<config>.json``  the deployment (graph family, sizes,
  engine options, source, cuts);
* ``bench/traffic/<mix>.json``     the traffic mix (spec kind, sources per
  spec, how sources are drawn, loop and clients);
* ``bench/graphs/<generator>.py``  the graph family's generator on the card;
* ``bench/metrics/<metric>.py``    the reader of one per-layer metric.

The reference (``bench/reference``) is plain PyTorch and imports nothing
of the port.
"""
