"""Fault tolerance for the serving plane: heartbeats, straggler detection
and restart policy (:mod:`repro_torch.distributed.fault`).  The mesh and
sharding helpers of the JAX package are not part of the port yet."""
