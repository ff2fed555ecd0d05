"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python3 zipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything that belongs to
one configuration, traffic mix, cell or per-layer metric sits in a file of
its own under this folder, found by the name ``BENCHMARK.json`` gives it;
what belongs to one model family, by the configuration's ``model_type``.
"""
