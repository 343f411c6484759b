"""MQTT transport — broker-mediated pub/sub for mobile/IoT federation.

Mirror of fedml_core/distributed/communication/mqtt/mqtt_comm_manager.py:
topic scheme preserved: the server (id 0) publishes to ``fedml0_<cid>`` and
subscribes to ``fedml_<cid>``; client cid publishes ``fedml_<cid>`` and
subscribes ``fedml0_<cid>`` (mqtt_comm_manager.py:47-70). Payloads are the
binary Message frame, not JSON.

Transport selection: paho-mqtt when installed (any MQTT 3.1.1 broker);
otherwise the bundled minimal client (mqtt_mini.py) — same topic scheme,
same Message frames — so the backend works and is testable in environments
without paho (pair it with mqtt_mini.MiniMqttBroker for loopback runs).

Retained-message discipline (persistent-broker safety): ONLY the server's
downlinks are retained — that is the documented startup-race fix (a client
that boots late still gets the init/sync). Client uplinks are never
retained: against a persistent broker a retained uplink outlives the job,
and a later run's server would count a stale final-round model upload
toward its round 0. On a clean server stop the retained downlinks are
cleared with empty retained payloads (MQTT 3.1.1 §3.3.1.3 tombstones), and
``job_id`` namespaces the topics so concurrent/successive jobs sharing a
broker cannot cross-talk at all.

An uplink published while the server is OFFLINE is dropped (no retained
copy, and clean-session semantics keep no queue — same as the reference's
paho default). That loss self-heals at the protocol layer: a restarted
server resumes from its round checkpoint and re-broadcasts the sync for
that round (distributed/fedavg/server_manager.py run/send_init_msg), and
stateless clients retrain and re-upload — the dropped frame belonged to a
round the server re-runs anyway.
"""

from __future__ import annotations

import logging
import uuid

from fedml_tpu_torch.comm.base import BaseCommManager
from fedml_tpu_torch.comm.message import Message

log = logging.getLogger("fedml_tpu_torch.comm.mqtt")


class MqttCommManager(BaseCommManager):
    backend_name = "mqtt"

    def __init__(self, broker_host: str, broker_port: int, client_id: int,
                 client_num: int, job_id: str | None = None):
        super().__init__()
        self.client_id, self.client_num = client_id, client_num
        # job namespace: '' keeps the reference's exact topic scheme; a
        # launcher-provided job_id isolates runs sharing a persistent broker
        self._ns = f"{job_id}/" if job_id else ""
        self._retained_topics: set[str] = set()  # server downlinks to clear on stop
        name = f"fedml_tpu-{client_id}-{uuid.uuid4().hex[:6]}"
        try:
            import paho.mqtt.client as mqtt
        except ImportError:
            from fedml_tpu_torch.comm.mqtt_mini import MiniMqttClient

            self._mini = MiniMqttClient(
                broker_host, broker_port, name,
                on_message=lambda topic, payload: self._on_payload(payload))
            self._client = None
            for t in self._sub_topics():
                self._mini.subscribe(t, qos=1)
            log.info("mqtt: paho absent, using bundled minimal client")
            return

        self._mini = None
        if hasattr(mqtt, "CallbackAPIVersion"):  # paho-mqtt >= 2.0
            self._client = mqtt.Client(mqtt.CallbackAPIVersion.VERSION2, client_id=name)
        else:  # paho-mqtt 1.x
            self._client = mqtt.Client(client_id=name)
        self._client.on_connect = self._on_connect
        self._client.on_message = self._on_message
        # same boot-order tolerance as the mini client (shared retry helper)
        from fedml_tpu_torch.comm.mqtt_mini import retry_connect

        retry_connect(
            lambda: self._client.connect(broker_host, broker_port, keepalive=180),
            f"broker {broker_host}:{broker_port}")
        self._client.loop_start()

    # topic scheme parity (mqtt_comm_manager.py:47-70), optionally namespaced
    def _sub_topics(self):
        if self.client_id == 0:  # server listens to every client's uplink
            return [f"{self._ns}fedml_{cid}"
                    for cid in range(1, self.client_num + 1)]
        return [f"{self._ns}fedml0_{self.client_id}"]

    def _pub_topic(self, receiver_id: int) -> str:
        if self.client_id == 0:
            return f"{self._ns}fedml0_{receiver_id}"
        return f"{self._ns}fedml_{self.client_id}"

    def _on_connect(self, client, userdata, flags, rc, properties=None):
        # signature covers both paho v1 (4 args) and v2 (5 args) callbacks
        for t in self._sub_topics():
            client.subscribe(t, qos=1)

    def _on_payload(self, payload: bytes) -> None:
        if not payload:  # retained-clear tombstone (§3.3.1.3), not a frame
            return
        self._receive_frame(payload)

    def _on_message(self, client, userdata, m):
        self._on_payload(m.payload)

    def send_message(self, msg: Message) -> None:
        # Server downlinks are retained (parties boot in arbitrary order and
        # a pub/sub broker drops messages for not-yet-subscribed topics;
        # retaining the last sync frame lets a late client catch up — the
        # gRPC backend's wait_for_ready analogue; the reference leaves this
        # race unhandled). Client uplinks are NOT retained — see module
        # docstring (stale-upload corruption on persistent brokers). Clients
        # only publish after receiving the server's (retained) init, by which
        # point the server's uplink subscriptions are long established.
        topic = self._pub_topic(int(msg.get_receiver_id()))
        retain = self.client_id == 0
        if retain:
            self._retained_topics.add(topic)
        self._publish(topic, self._encode(msg), retain)

    def _publish(self, topic: str, payload: bytes, retain: bool):
        if self._mini is not None:
            self._mini.publish(topic, payload, qos=1, retain=retain)
            return None
        return self._client.publish(topic, payload=payload, qos=1, retain=retain)

    def stop_receive_message(self) -> None:
        super().stop_receive_message()
        # clear our retained downlinks so they cannot leak into a later run
        # sharing this (possibly persistent) broker. On paho, publish() only
        # QUEUES on the network loop — wait for each tombstone to go out
        # before loop_stop(), or the clear never reaches the broker.
        infos = []
        for topic in sorted(self._retained_topics):
            try:
                infos.append(self._publish(topic, b"", retain=True))
            except Exception:  # noqa: BLE001 — best-effort during teardown
                log.warning("mqtt: failed to clear retained topic %s", topic)
        for info in infos:
            if info is not None:  # paho MQTTMessageInfo
                try:
                    info.wait_for_publish(timeout=5)
                except Exception:  # noqa: BLE001
                    log.warning("mqtt: retained-clear flush timed out")
        if self._mini is not None:
            self._mini.close()
            return
        self._client.loop_stop()
        self._client.disconnect()
