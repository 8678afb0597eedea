"""Fault tolerance for the serving plane: heartbeats, straggler detection
and restart policy (:mod:`repro_torch.distributed.fault`), and the node
mesh of the partitioned engine (:mod:`repro_torch.distributed.ctx`).  The
JAX package's logical-axis rules and sharding helpers serve its model zoo
and are not part of the port yet."""
