"""Distribution of the port: the logical-axis sharding rules and the
logical device mesh that shard-granular cold starts plan against
(:mod:`repro_torch.distributed.sharding`)."""
