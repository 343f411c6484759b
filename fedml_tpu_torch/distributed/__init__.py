"""Cross-process distributed FL, port of fedml_tpu/distributed: one OS
process (or thread, under the loopback backend) per participant,
coordinated by typed messages over fedml_tpu_torch/comm. This slice
carries synchronous FedAvg (``distributed.fedavg``) with elastic partial
aggregation; the other algorithms' distributed twins are queued in
ROADMAP.md (queue A, item 9)."""
