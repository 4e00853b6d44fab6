"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells and metrics; each
piece lives in a file of its own here and is found by its name:
``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<traffic>.json``, ``drivers/<driver>.py`` and
``metrics/<metric>.py``.  ``reference/`` is the plain reference that decides
``correct``; ``data/`` the input generator.
"""
