"""Host-side control plane of the port: failure and straggler detection
(:mod:`repro_torch.distributed.fault`).  Sharding is single-controller
(:mod:`repro_torch.core.shard_exec`, :mod:`repro_torch.launch.mesh`)."""
