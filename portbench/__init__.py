"""Benchmark of the PyTorch and CUDA port (``efa_xray_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; see ``portbench/README.md``.
"""
