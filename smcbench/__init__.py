"""The benchmark of genparticlefilters_tpu_torch on one CUDA card.

``python3 smcbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` (see ``run.py``).
"""
