"""nanort_tpu_torch.parallel: ray-parallel and chunk-sharded traversal
over ``torch.distributed`` (``mesh``, ``sharded_scene``), and
``dryrun.dryrun_multichip``, which runs them on spawned ranks."""
