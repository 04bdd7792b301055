"""The benchmark of ``fourier_tpu_torch`` on the card.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Everything that belongs to one item is a file of its own, found by
name: ``configs/<config>.json`` (the deployment), ``traffic/<mix>.json``
(the mix's parameters and the generator that reads them), ``kinds/<kind>.py``
(the generators), ``metrics/<metric>.py`` (one reader a metric). The
yardstick is here too: ``work.py`` (operations and bytes from shapes),
``peaks.py`` (the card's published peaks), ``trace.py`` (the profiler's
record reduced to busy time, classes of kernels and idle gaps) and
``reference/`` (plain PyTorch, independent of the port).
"""
