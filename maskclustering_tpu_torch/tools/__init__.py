"""Operational tools of the port: the serving load generator and its drills,
the fault-matrix and streaming smokes, and the CI gate over them.

Each is a module run with ``python -m maskclustering_tpu_torch.tools.<name>``
and keeps the flags, verdict lines and exit codes of the JAX package's
top-level script of the same name (``scripts/load_gen.py``,
``scripts/fault_smoke.py``, ``scripts/stream_smoke.py``, ``scripts/ci.sh``).
The daemons and runs they start use the CUDA card unless ``--device cpu``
is given; asked for the card on a host without one, they raise.
"""
