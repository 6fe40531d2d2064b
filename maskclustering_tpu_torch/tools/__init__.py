"""Operational and measurement tools of the port.

- the serving load generator and its drills (``load_gen``), the
  fault-matrix and streaming smokes (``fault_smoke``, ``stream_smoke``) and
  the CI gate over them (``ci``);
- the measurement and diagnostic tools on the bench's device-rendered scene
  (``utils/synthetic.make_scene_device``): the profiler capture of one
  bench-scale scene (``profile_scene``), the post-process profile
  (``profile_postprocess``), the node-stats and drain attribution
  (``claims_diag``), the frame-batch and card-against-CPU identity of the
  association (``fb_identity``), the multi-scene north-star sweep
  (``northstar``), the dense-against-exact parity A/B (``parity_ab``), the
  mesh benchmark (``mesh_bench``), the fused step's memory at the honest
  bucket (``hbm_analysis``) and the primitive micro-benchmarks (``micro``).

Each is a module run with ``python -m maskclustering_tpu_torch.tools.<name>``
and keeps the flags, verdict lines and exit codes of the JAX package's
top-level script of the same name (``scripts/<name>.py``; ``ci`` is
``scripts/ci.sh``, ``profile_scene`` ``scripts/profile_scene_tpu.py`` and
``micro`` ``scripts/micro_tpu.py``). The runs they start use the CUDA card
unless ``--device cpu`` is given; asked for the card on a host without one,
they raise. A file they write by default lands under ``build/tools/``
(gitignored), never on a tracked record.
"""
