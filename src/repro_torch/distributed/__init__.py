"""Host-side control plane of the port: failure and straggler detection
(:mod:`repro_torch.distributed.fault`).  Sharding comes with the
multi-device slice."""
