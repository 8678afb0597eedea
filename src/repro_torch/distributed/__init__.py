"""Fault tolerance for the serving plane: heartbeats, straggler detection
and restart policy (:mod:`repro_torch.distributed.fault`), and the node
mesh of the partitioned engine and the logical-axis rule context
(:mod:`repro_torch.distributed.ctx`), and the sharding rule tables
(:mod:`repro_torch.distributed.shard`)."""
