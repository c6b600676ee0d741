"""The port's distribution layer, single-controller: sharding rules and
placement (:mod:`~repro_torch.distributed.sharding`), tensor-parallel
compute over the ``model`` axis
(:mod:`~repro_torch.distributed.tensor_parallel`), the GPipe pipeline
(:mod:`~repro_torch.distributed.pipeline`), elastic re-meshing
(:mod:`~repro_torch.distributed.elastic`) and failure and straggler
detection (:mod:`~repro_torch.distributed.fault`).  The GNN engine's
row-band sharding is :mod:`repro_torch.core.shard_exec`; meshes are
:mod:`repro_torch.launch.mesh`."""
