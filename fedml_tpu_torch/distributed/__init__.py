"""Cross-process distributed FL, port of fedml_tpu/distributed: one OS
process (or thread, under the loopback backend) per participant,
coordinated by typed messages over fedml_tpu_torch/comm: FedAvg
(``distributed.fedavg``: synchronous and buffered-async rounds, elastic,
the edge tier, crash recovery), its robust / accounted-DP server
(``distributed.fedavg_robust``) and masked secure aggregation
(``distributed.turboaggregate``, flat and hierarchical); the other
algorithms' distributed twins are queued in ROADMAP.md (queue A, item
9)."""
