"""The port's counterparts of the JAX package's ``examples/`` scripts.

Each module has the JAX script's file name and prints its lines, and is
run as ``python -m efa_xray_tpu_torch.examples.<name>`` (add ``--device
cpu`` without a card).  Each splits into ``parse_args(argv)``,
``inputs(args)`` (what the script starts from, NumPy-seeded), ``run(args,
inputs)`` (the compute steps: a dict of every number the script prints,
its own assertions kept), ``report(args, result)`` (the printed lines),
the file or plot step where the script has one (``persist`` / ``plot``,
which need h5py or matplotlib), and ``main(argv=None)``.
"""
