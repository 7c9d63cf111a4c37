"""The benchmark of ``uc2_torch`` on NVIDIA H100 cards.

``python -m h100bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything a cell needs is found by name: its
configuration in ``configs/``, its traffic in ``traffic/``, its check
limits in ``workloads/``, its per-layer metrics in ``metrics/``; the code
that drives an entry of the port is ``drivers/<traffic's driver>.py``.
``frozen/`` holds the arithmetic copied from the program at a fixed commit
(operation counts, roofline bounds, input generators) and ``reference/``
the plain fp32 model that decides ``correct``.
"""
