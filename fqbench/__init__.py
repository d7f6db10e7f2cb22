"""The benchmark of fastqueeze_tpu_torch on NVIDIA H100 cards.

``python3 fqbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; ``harness``
holds the job loop and the check, ``tracing`` the traced job, ``gen`` the
seeded FASTQ generator, ``reference/`` the plain reference, and
``configs/``, ``mixes/``, ``metrics/`` and ``counts/`` one file per
configuration, mix, per-layer metric and kernel.
"""
