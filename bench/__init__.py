"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on NVIDIA H100s.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``. Every configuration, traffic mix, cell
and metric is a file of its own under this folder, found by the name the
manifest gives it: ``configs/<config>.json``, ``traffic/<traffic>.json``
(whose ``kind`` names its driver, ``drivers/<kind>.py``),
``cells/<cell>.json`` (the limits that decide ``correct``) and
``metrics/<metric>.py`` (a reader of the run's record).
"""
