"""L1 communication layer, port of fedml_tpu/comm: the reference's second
computing paradigm, one OS process (or thread) per participant with
messages over a wire.

Backends: ``loopback`` (in-process queues, threads as ranks), ``grpc``
(one server per rank at base_port + rank) and ``mqtt`` (broker pub/sub,
the bundled MQTT 3.1.1 client and broker when paho is absent). Frames are
byte-identical to the JAX package's: the FMT2 frame with its CRC32, the
FMZ1 deflate wrapper and the f16 / q8 / json codecs are copies, and
``pack_pytree`` ships a model's params in flax layout and order, so a
torch rank and a JAX rank share one job. The update tiers — ``delta``
(round deltas, int8 and 1-bit), ``sparse`` (top-k) and ``ef`` (the
shared error-feedback residual) — are copies too, numpy on the host.
"""

from fedml_tpu_torch.comm.base import BaseCommManager
from fedml_tpu_torch.comm.loopback import LoopbackCommManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.observer import Observer

__all__ = ["BaseCommManager", "LoopbackCommManager", "Message", "Observer"]
