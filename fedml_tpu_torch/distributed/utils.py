"""Worker-mapping config for the cross-process runtime.

Mirror of the reference's gpu_mapping.yaml + grpc_ipconfig.csv pair
(fedml_api/distributed/utils/gpu_mapping.py:8-37 maps MPI rank -> (host,
cuda device); ip_config_utils.py maps rank -> ip). On TPU there is no
per-process accelerator binding to manage — XLA owns the chips — so the
mapping collapses to rank -> host for message routing, plus optional
per-rank TPU visibility for multi-host jobs.

YAML schema:
    workers:
      - host: 10.0.0.1     # ranks are assigned in listed order
        ranks: [0, 1]
      - host: 10.0.0.2
        ranks: [2, 3, 4]
"""

from __future__ import annotations


def load_worker_mapping(path: str) -> dict[int, str]:
    """rank -> host, usable directly as GrpcCommManager's ip_table."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    table: dict[int, str] = {}
    for entry in doc["workers"]:
        for r in entry["ranks"]:
            if r in table:
                raise ValueError(f"rank {r} mapped twice")
            table[int(r)] = str(entry["host"])
    return table


def mapping_to_ip_config_csv(table: dict[int, str], path: str) -> None:
    """Write the reference-format csv (receiver_id,ip) for interop."""
    with open(path, "w") as f:
        f.write("receiver_id,ip\n")
        for r in sorted(table):
            f.write(f"{r},{table[r]}\n")


def backend_kwargs(backend: str, job_id: str, base_port: int = 50000,
                   broker_host: str = "127.0.0.1",
                   broker_port: int = 1883) -> dict:
    """Transport-specific kwargs for make_comm_manager: loopback routes by
    job_id; gRPC by port block (reference: grpc_comm_manager.py:29 port =
    50000+rank); MQTT by broker address (mqtt_comm_manager.py)."""
    b = backend.upper()
    if b == "LOOPBACK":
        return {"job_id": job_id}
    if b == "MQTT":
        return {"broker_host": broker_host, "broker_port": broker_port}
    return {"base_port": base_port}


def launch_simulated(server, clients, join_timeout: float = 60.0):
    """Run all ranks as threads on one host — the mpirun-on-localhost
    analogue every run_simulated shares (reference SURVEY.md §4.5: "fake
    cluster = many processes on one box"). Blocks in the server's receive
    loop; returns once every client thread drained FINISH."""
    import threading

    threads = [threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    server.run()
    for t in threads:
        t.join(timeout=join_timeout)
    return server
