"""Data parallel over ``torch.distributed`` ranks (counterpart of
``rise_sdf_tpu/parallel``): ``sharding`` holds the rank arithmetic and
the collectives, ``dryrun`` spawns ranks."""
