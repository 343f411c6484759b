"""Typed key-value message envelope with zero-copy array payloads.

Mirror of fedml_core/distributed/communication/message.py:5-74 (Message =
dict of params keyed by type/sender/receiver, carrying model params in-band).

Wire-format redesign: the reference JSON-encodes model weights as nested
python lists for its gRPC/MQTT paths (fedml_api/distributed/fedavg/
utils.py:7-16) and pickles them for MPI — both slow and (pickle) unsafe.
Here the envelope is a self-describing binary frame:

    b"FMT1" | u32 header_len | header(JSON) | raw array buffers...

Scalars ride in the JSON header; every numpy/JAX array (or list of arrays —
the natural shape of a flattened pytree of weights) is shipped as raw
little-endian bytes described by a manifest. Encoding a pytree is
tree_flatten on the sender and unflatten-by-structure on the receiver, so no
class bytecode ever crosses the wire.

Frame integrity: the binary frame carries a CRC32 of everything after the
checksum field (FMT2). A receiver that computes a mismatch raises
:class:`CorruptFrame`, which the dispatch path (``BaseCommManager.
_receive_frame``) turns into a counted drop (``comm_corrupt_frames_total``)
instead of a crashed receive loop — a flipped bit on the wire degrades one
frame, not the job. Legacy FMT1 frames (no checksum) still decode — the
compatibility is old-sender -> new-receiver only: senders emit FMT2
unconditionally, which a pre-integrity receiver rejects, so upgrade
receivers before (or with) senders. The 'json' interop tier carries no
checksum (a stock reference peer wouldn't know to send one).
"""

from __future__ import annotations

import functools
import json
import os
import zlib
from typing import Any

import numpy as np

_MAGIC = b"FMT1"   # legacy: no integrity field (still decoded)
_MAGIC2 = b"FMT2"  # FMT2 | u32 header_len | u32 crc32(rest) | header | bufs
_ZMAGIC = b"FMZ1"  # zlib-wrapped frame: FMZ1 | u32 raw_len | deflate bytes


class CorruptFrame(ValueError):
    """A wire frame that failed its integrity check (CRC32 mismatch, bad
    magic, or an undecodable body). Subclasses ValueError so pre-existing
    callers that caught ValueError keep working."""

# Wire codec (sender-side choice; receivers auto-detect, so mixed peers
# interoperate). The reference ships f32 weights as JSON lists — here the
# baseline is already raw binary, and the codec trades further:
#   'f16'  — cast float32 array payloads to float16 on the wire (2x; the
#            classic FL uplink compression; manifest records the original
#            dtype so receivers restore f32 — a ~1e-3-relative quantization
#            of the weights, NOT bit-exact)
#   'q8'   — symmetric int8 quantization of float32 payloads (4x; scale =
#            max|x|/127 per array, kept in the manifest; ~0.4% of the
#            array's max absolute value per entry — the aggressive tier)
#   'zlib' — lossless deflate of the whole frame (big wins on int/uint8
#            payloads and sparse updates; modest on dense f32)
#   '+zlib' composes with either lossy tier. f16 and q8 are mutually
#   exclusive (both re-encode the same f32 payloads).
#   'json' — the REFERENCE's wire format: one UTF-8 JSON object of
#            msg_params with arrays as nested python lists (Message.to_json,
#            message.py:62-66 + transform_tensor_to_list,
#            fedavg/utils.py:13-16, the is_mobile=1 path) — so a stock
#            reference mobile/IoT client can join a fedml_tpu round.
#            Interop tier only: ~7x the bytes of the binary frame.
_CODECS = ("none", "f16", "q8", "zlib", "f16+zlib", "q8+zlib", "json")


def set_wire_codec(codec: str) -> None:
    """Process-wide default codec for Message.to_bytes (one of _CODECS:
    'none', 'f16', 'q8', 'zlib', 'f16+zlib', 'q8+zlib', 'json'). Exposed
    on the CLI as --compression."""
    global _CODEC
    if codec not in _CODECS:
        raise ValueError(f"unknown wire codec {codec!r} (one of {_CODECS})")
    _CODEC = codec


def _codec_from_env() -> str:
    # a typo in the env var must not SILENTLY ship uncompressed frames
    # while the operator believes compression is on — warn and run plain
    v = os.environ.get("FEDML_COMM_CODEC", "none")
    if v not in _CODECS:
        import logging

        logging.getLogger("fedml_tpu_torch.comm").warning(
            "FEDML_COMM_CODEC=%r is not one of %s — using 'none'", v, _CODECS)
        return "none"
    return v


_CODEC = _codec_from_env()


def _f16_wire(arr: np.ndarray) -> np.ndarray:
    """float32 -> its f16 wire form. Saturates at the f16 range: a stray
    huge value (diverging weight, unscaled statistic) must degrade to
    ±65504, not become inf and poison every peer's aggregate."""
    return np.clip(arr, -65504.0, 65504.0).astype(np.float16)


def _q8_wire(arr: np.ndarray) -> tuple[np.ndarray, float]:
    """float32 -> (int8 wire form, scale). Non-finite guard: nan→0 and
    ±inf saturate to the largest FINITE magnitude so one diverged entry
    can't blow the scale up / NaN the decode.

    Policy note: this clamp exists because q8's SCALE computation would
    otherwise be destroyed by a single non-finite entry — it is a codec
    necessity, not a sanitization layer. The plain float paths ('none',
    'f16' pre-clip aside, 'zlib', 'json') deliberately ship the sender's
    bits verbatim: silently laundering a NaN to 0 at unpack time would
    hide a diverging or hostile client from every defense. Non-finite
    uploads are instead REJECTED, counted, and quarantined by the
    aggregation-side sanitation gate (core/robust_agg.sanitize_updates,
    unconditional in FedAvgAggregator.aggregate) — a NaN can reach the
    server, but never ``tree_weighted_mean``, and never unannounced."""
    finite = np.isfinite(arr)
    if not finite.all():
        amax = float(np.max(np.abs(arr[finite]))) if finite.any() else 0.0
        arr = np.nan_to_num(arr, nan=0.0, posinf=amax, neginf=-amax)
    scale = float(np.max(np.abs(arr))) / 127.0 if arr.size else 0.0
    q = (np.zeros(arr.shape, np.int8) if scale == 0.0 else
         np.clip(np.rint(arr / scale), -127, 127).astype(np.int8))
    return q, scale


class Message:
    MSG_ARG_KEY_TYPE = "msg_type"
    MSG_ARG_KEY_SENDER = "sender"
    MSG_ARG_KEY_RECEIVER = "receiver"

    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_CLIENT_INDEX = "client_idx"

    # Keys the lossy f16/q8 frame tiers must NEVER re-encode, whatever the
    # process-wide codec says. These are codec/protocol payloads, not model
    # tensors: a sparse top-k value array is EXACTLY what the server adds to
    # its global (quantizing it would silently break the client's error-
    # feedback accounting — the residual assumes what was SENT is what was
    # APPLIED), an update-codec scale vector quantized by q8 corrupts every
    # entry it scales, and a round-delta broadcast must reconstruct the
    # exact base the next uplink delta is computed against. Integer leaves
    # (sparse_idx) dodge the float tiers by dtype today, but are listed so
    # the exemption is a protocol contract, not a dtype accident.
    LOSSY_EXEMPT = frozenset({
        "sparse_idx", "sparse_val",          # comm/sparse.py top-k uplinks
        "upd_q", "upd_scale",                # comm/delta.py update tiers
        "delta_params",                      # round-delta broadcast payload
    })

    def __init__(self, type: str = "default", sender_id: int = 0, receiver_id: int = 0):
        self.msg_params: dict[str, Any] = {
            Message.MSG_ARG_KEY_TYPE: type,
            Message.MSG_ARG_KEY_SENDER: sender_id,
            Message.MSG_ARG_KEY_RECEIVER: receiver_id,
        }
        # per-message additions to LOSSY_EXEMPT (mark_lossless): e.g. the
        # delta-broadcast protocol's dense fallback, whose model_params must
        # land bit-exact so every rank holds the same base chain value
        self._lossless_keys: set[str] = set()

    # -------------------------------------------------------- dict interface
    def add_params(self, key: str, value: Any):
        self.msg_params[key] = value

    def mark_lossless(self, key: str) -> None:
        """Exempt ``key``'s array payload from the lossy f16/q8 frame
        tiers on THIS message (zlib still applies — it is lossless)."""
        self._lossless_keys.add(key)

    def get(self, key: str, default=None):
        return self.msg_params.get(key, default)

    def get_type(self) -> str:
        return self.msg_params[Message.MSG_ARG_KEY_TYPE]

    def get_sender_id(self) -> int:
        return self.msg_params[Message.MSG_ARG_KEY_SENDER]

    def get_receiver_id(self) -> int:
        return self.msg_params[Message.MSG_ARG_KEY_RECEIVER]

    def get_params(self) -> dict:
        return self.msg_params

    # ---------------------------------------------------------- wire format
    @staticmethod
    def _as_array(v):
        """numpy view of an array-like leaf (jax.Array included) or None."""
        if isinstance(v, np.ndarray):
            return v
        if hasattr(v, "__array__") and hasattr(v, "dtype") and hasattr(v, "shape"):
            return np.asarray(v)
        return None

    def to_bytes(self, codec: str | None = None) -> bytes:
        codec = _CODEC if codec is None else codec
        if codec not in _CODECS:
            raise ValueError(f"unknown wire codec {codec!r} (one of {_CODECS})")
        if codec == "json":
            return self._to_reference_json()
        f16, q8 = "f16" in codec, "q8" in codec
        scalars: dict[str, Any] = {}
        manifest: list[dict] = []
        buffers: list[bytes] = []
        # protocol payloads the lossy tiers must not touch (class contract
        # + per-message mark_lossless; getattr: a Message rebuilt by
        # from_bytes and re-encoded — chaos duplicates — has no set)
        exempt = self.LOSSY_EXEMPT | getattr(self, "_lossless_keys", set())

        def put_array(key, idx, arr):
            arr = np.ascontiguousarray(arr)
            ent = {"key": key, "idx": idx, "dtype": arr.dtype.str,
                   "shape": list(arr.shape)}
            if key in exempt:
                pass  # verbatim bits, whatever the frame codec says
            elif f16 and arr.dtype == np.float32:
                ent["orig"], ent["dtype"] = arr.dtype.str, "<f2"
                arr = _f16_wire(arr)
            elif q8 and arr.dtype == np.float32:
                ent["orig"], ent["dtype"] = arr.dtype.str, "|i1"
                arr, ent["scale"] = _q8_wire(arr)
            manifest.append(ent)
            buffers.append(arr.tobytes())

        for key, val in self.msg_params.items():
            arr = self._as_array(val)
            if arr is not None:
                put_array(key, None, arr)
            elif isinstance(val, (list, tuple)) and val and all(
                self._as_array(v) is not None for v in val
            ):
                for i, v in enumerate(val):
                    put_array(key, i, self._as_array(v))
                scalars["__len_" + key] = len(val)
            else:
                scalars[key] = val

        header = json.dumps({"scalars": scalars, "arrays": manifest}).encode()
        body = b"".join([header] + buffers)
        # crc covers header + payload (everything after the crc field):
        # one pass over bytes already in cache — the only per-frame work
        # the integrity layer adds to the no-chaos hot path
        frame = b"".join([_MAGIC2, len(header).to_bytes(4, "little"),
                          (zlib.crc32(body) & 0xFFFFFFFF).to_bytes(4, "little"),
                          body])
        if "zlib" in codec:
            frame = (_ZMAGIC + len(frame).to_bytes(4, "little")
                     + zlib.compress(frame, 1))  # level 1: wire CPU is cheap
        return frame

    def _to_reference_json(self) -> bytes:
        """The reference's wire form: json.dumps(msg_params) with every
        array payload as nested lists (message.py:62-66 to_json; weights
        listified per transform_tensor_to_list, fedavg/utils.py:13-16).

        Decode-symmetry extension (ADVICE r5 item 1): the frame also carries
        an ``__arrays__`` manifest naming every top-level key that was
        listified, with its dtype(s) — so ``_from_reference_json`` can
        restore ndarrays for EVERY protocol's array params (split_nn
        acts/grads, fedgkt feats/logits, sparse idx/val...), not just
        ``model_params``, and with the sender's dtype instead of a blanket
        float32. A stock reference peer ignores the extra key (its decode
        is a plain json.loads into the params dict), so interop holds; a
        stock reference SENDER omits it and we fall back to the
        ``model_params``-only heuristic arrify below."""
        manifest: dict[str, Any] = {}

        def listify(v):
            arr = self._as_array(v)
            if arr is not None:
                return arr.tolist()
            if isinstance(v, (list, tuple)):
                return [listify(e) for e in v]
            if isinstance(v, dict):
                return {k: listify(e) for k, e in v.items()}
            return v

        doc: dict[str, Any] = {}
        for k, v in self.msg_params.items():
            arr = self._as_array(v)
            if arr is not None:
                doc[k] = arr.tolist()
                manifest[k] = arr.dtype.str
            elif isinstance(v, (list, tuple)) and v and all(
                self._as_array(e) is not None for e in v
            ):
                arrs = [self._as_array(e) for e in v]
                doc[k] = [a.tolist() for a in arrs]
                manifest[k] = [a.dtype.str for a in arrs]
            elif isinstance(v, dict) and v and all(
                self._as_array(e) is not None for e in v.values()
            ):  # state_dict shape: key -> one tensor
                arrs2 = {k2: self._as_array(e) for k2, e in v.items()}
                doc[k] = {k2: a.tolist() for k2, a in arrs2.items()}
                manifest[k] = {k2: a.dtype.str for k2, a in arrs2.items()}
            else:
                doc[k] = listify(v)
        if manifest:
            doc["__arrays__"] = manifest
        return json.dumps(doc).encode()

    # reference integer msg types (fedavg/message_define.py:6-11) -> the
    # string vocabulary fedml_tpu managers register handlers under
    # (distributed/fedavg/message_define.py) — without this translation a
    # stock reference client's upload would parse but never dispatch
    _REFERENCE_MSG_TYPES = {1: "s2c_init", 2: "s2c_sync",
                            3: "c2s_send_model", 4: "c2s_send_stats"}

    # Decode-symmetry fallback for manifest-LESS json frames (ADVICE r5
    # item 1): ``to_bytes('json')`` listifies EVERY array param, so a
    # receiver must restore ndarrays for every protocol's array keys, not
    # just ``model_params`` — otherwise --compression json hands split_nn/
    # fedgkt/vfl handlers nested python lists. fedml_tpu senders attach the
    # ``__arrays__`` manifest (exact keys + dtypes, handled above); this
    # table covers frames from stock peers that don't. Values are
    # (wire dtype, kind): 'leaves' = a LIST of tensors (pack_pytree shape —
    # nested-list depth is per-tensor), 'array' = ONE tensor however deep
    # its nesting. Dtypes are the senders' conventional ones — best-effort
    # by construction (the manifest path is the exact one).
    _KNOWN_ARRAY_KEYS = {
        "model_params": ("<f4", "leaves"),   # fedavg weights
        "params": ("<f4", "leaves"),         # vfl final host params
        "sparse_idx": ("<i4", "leaves"),     # comm/sparse top-k uplinks
        "sparse_val": ("<f4", "leaves"),
        "upd_q": ("|u1", "leaves"),          # comm/delta quantized payloads
        "upd_scale": ("<f4", "array"),       # comm/delta per-leaf scales
        "delta_params": ("<f4", "leaves"),   # round-delta broadcast
        "acts": ("<f4", "array"),            # split_nn activations
        "grads": ("<f4", "array"),           # split_nn / vfl cotangents
        "feats": ("<f4", "array"),           # fedgkt features
        "s_logits": ("<f4", "array"),        # fedgkt server logits
        "c_logits": ("<f4", "array"),        # fedgkt client logits
        "logits": ("<f4", "array"),          # vfl host logit contribution
        "labels": ("<i8", "array"),
        "mask": ("<f4", "array"),
        "sel": ("<i8", "array"),             # vfl batch index selection
    }

    @classmethod
    def _from_reference_json(cls, data: bytes) -> "Message":
        msg = cls.__new__(cls)
        msg.msg_params = json.loads(data)
        t = msg.msg_params.get(Message.MSG_ARG_KEY_TYPE)
        if isinstance(t, int):
            msg.msg_params[Message.MSG_ARG_KEY_TYPE] = \
                cls._REFERENCE_MSG_TYPES.get(t, str(t))

        manifest = msg.msg_params.pop("__arrays__", None)
        if manifest is not None:
            # fedml_tpu sender: restore ndarrays (with the sender's dtype)
            # for exactly the keys it listified — symmetric for every
            # protocol's array params, not just model_params
            for k, spec in manifest.items():
                v = msg.msg_params.get(k)
                if v is None:
                    continue
                if isinstance(spec, list):  # list-of-arrays payload
                    msg.msg_params[k] = [np.asarray(e, np.dtype(d))
                                         for e, d in zip(v, spec)]
                elif isinstance(spec, dict):  # state_dict-shaped payload
                    msg.msg_params[k] = {k2: np.asarray(v[k2], np.dtype(d))
                                         for k2, d in spec.items()}
                else:
                    msg.msg_params[k] = np.asarray(v, np.dtype(spec))
            return msg

        def arrify(v, dtype, kind):  # transform_list_to_tensor analogue
            if isinstance(v, dict):
                # reference state_dict shape: key -> ONE tensor as nested
                # lists, however deep
                return {k: np.asarray(e, dtype) for k, e in v.items()}
            if kind == "leaves" and isinstance(v, list) and v \
                    and isinstance(v[0], list):
                # fedml_tpu pack_pytree shape: a LIST of tensors
                return [np.asarray(e, dtype) for e in v]
            if isinstance(v, list):
                return np.asarray(v, dtype)
            return v

        # stock sender (no manifest): restore every KNOWN array-valued key
        # of the protocol vocabulary (fedavg weights, split_nn acts/grads,
        # fedgkt feats/logits, vfl sel, sparse idx/val) instead of only
        # model_params — the decode-asymmetry fix for interop frames
        for k, (dtype, kind) in cls._KNOWN_ARRAY_KEYS.items():
            if k in msg.msg_params:
                msg.msg_params[k] = arrify(msg.msg_params[k],
                                           np.dtype(dtype), kind)
        return msg

    @classmethod
    def from_bytes(cls, data: bytes) -> "Message":
        if data[:1] == b"{":  # auto-detect: reference-format JSON peer
            return cls._from_reference_json(data)
        if data[:4] == _ZMAGIC:  # auto-detect: sender chose zlib
            # raw_len (bytes 4:8) is advisory; zlib integrity-checks itself
            try:
                data = zlib.decompress(data[8:])
            except zlib.error as e:  # deflate stream damaged in transit
                raise CorruptFrame(f"zlib frame failed to inflate: {e}")
        if data[:4] == _MAGIC2:
            body_off = 12
            crc = int.from_bytes(data[8:12], "little")
            if zlib.crc32(data[12:]) & 0xFFFFFFFF != crc:
                raise CorruptFrame("frame CRC32 mismatch")
        elif data[:4] == _MAGIC:  # legacy peer: no integrity field
            body_off = 8
        else:
            raise CorruptFrame("bad message frame")
        hlen = int.from_bytes(data[4:8], "little")
        header = json.loads(data[body_off : body_off + hlen])
        msg = cls.__new__(cls)
        msg.msg_params = {}

        lists: dict[str, int] = {}
        for k, v in header["scalars"].items():
            if k.startswith("__len_"):
                lists[k[len("__len_"):]] = v
            else:
                msg.msg_params[k] = v
        for key, n in lists.items():
            msg.msg_params[key] = [None] * n

        off = body_off + hlen
        for ent in header["arrays"]:
            arr = np.frombuffer(
                data, dtype=np.dtype(ent["dtype"]), count=int(np.prod(ent["shape"], dtype=np.int64)),
                offset=off,
            ).reshape(ent["shape"])
            off += arr.nbytes
            if "scale" in ent:  # q8: dequantize back to the sender's dtype
                arr = (arr.astype(np.dtype(ent["orig"]))
                       * np.dtype(ent["orig"]).type(ent["scale"]))
            elif "orig" in ent:  # f16-on-the-wire: restore the dtype
                arr = arr.astype(np.dtype(ent["orig"]))
            if ent["idx"] is None:
                msg.msg_params[ent["key"]] = arr
            else:
                msg.msg_params[ent["key"]][ent["idx"]] = arr
        return msg

    def __repr__(self):  # message-size print parity (message.py:64)
        return f"Message(type={self.get_type()}, {self.get_sender_id()}->{self.get_receiver_id()})"


def codec_roundtrip(leaves, codec: str | None = None) -> list:
    """The lossy transform each float32 array experiences on the wire under
    ``codec`` (encode then decode), without building a frame — identity for
    lossless codecs.

    A server that stashes its broadcast pack to densify sparse client
    deltas must stash THIS, not the pre-codec arrays: clients compute their
    delta against the broadcast they RECEIVED (the decoded, lossy copy), so
    densifying against the exact pack would add an untracked
    ``g_exact - g_lossy`` offset to every transmitted entry each round and
    break the ratio=1.0 dense-equivalence contract. Built from the same
    ``_f16_wire``/``_q8_wire`` helpers ``to_bytes`` encodes with, and the
    same f32*f32(scale) dequant ``from_bytes`` applies."""
    codec = _CODEC if codec is None else codec
    if codec not in _CODECS:
        raise ValueError(f"unknown wire codec {codec!r} (one of {_CODECS})")
    f16, q8 = "f16" in codec, "q8" in codec
    if not (f16 or q8):
        return list(leaves)
    out = []
    for arr in leaves:
        arr = np.asarray(arr)
        if arr.dtype != np.float32:
            out.append(arr)
            continue
        if f16:
            arr = _f16_wire(arr).astype(np.float32)
        else:
            q, scale = _q8_wire(arr)
            arr = q.astype(np.float32) * np.float32(scale)
        out.append(arr)
    return out


def pack_pytree(state, num_heads: int | None = None) -> list[np.ndarray]:
    """Flatten a port net into the wire leaves the JAX package sends for
    the same model (sender side): its flax params (HWIO convolution
    kernels, ``[in, out]`` dense kernels, the first dense layer's rows in
    NHWC order, a TransformerLM's attention kernels split by its
    ``num_heads``), then its extras, in ``net_items``' order. So a JAX peer
    decodes a port frame, and the other way round, with no layout
    knowledge on the wire."""
    return [leaf for _, leaf in net_items(state, num_heads)]


def unpack_pytree(template, leaves, num_heads: int | None = None) -> dict:
    """Rebuild a state dict from wire leaves using the receiver's own
    ``template`` state and head count (both sides construct the same
    model, so no treedef crosses the wire); the result lands on the
    template's device. Raises ValueError when the leaves' count, shapes or
    dtypes do not fit the template."""
    from fedml_tpu_torch.convert import from_flax

    params: dict = {}
    for (path, shape, dtype), leaf in zip(
            check_wire_leaves(template, leaves, num_heads), leaves):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.asarray(leaf)
    extra = ({"batch_stats": params.pop("batch_stats")}
             if "batch_stats" in params else {})
    state = from_flax(params, extra)
    return {k: state[k].to(v.device, v.dtype) for k, v in template.items()}


def check_wire_leaves(template, leaves, num_heads: int | None = None) -> tuple:
    """The wire layout of the template's model (``num_heads``: a
    TransformerLM's head count), ``(path, shape, dtype)`` per leaf; raises
    ValueError when ``leaves`` (a decoded upload) does not match it."""
    spec = _wire_spec(tuple((k, tuple(v.shape)) for k, v in
                            sorted(template.items())), num_heads)
    if len(leaves) != len(spec):
        raise ValueError(f"{len(leaves)} wire leaves, the model has "
                         f"{len(spec)}")
    for (path, shape, dtype), leaf in zip(spec, leaves):
        if np.shape(leaf) != shape or np.asarray(leaf).dtype != dtype:
            raise ValueError(f"wire leaf {'/'.join(path)}: "
                             f"{np.asarray(leaf).dtype}{list(np.shape(leaf))}"
                             f", the model has {dtype}{list(shape)}")
    return spec


@functools.lru_cache(maxsize=8)
def _wire_spec(shapes: tuple, num_heads: int | None) -> tuple:
    """(path, shape, dtype) of each wire leaf of a state with these
    ``(key, shape)`` entries and head count, from ``net_items`` of zeros
    (models' float32 params and extras only)."""
    import torch

    zeros = {k: torch.zeros(shape) for k, shape in shapes}
    return tuple((path, leaf.shape, leaf.dtype)
                 for path, leaf in net_items(zeros, num_heads))


def net_items(state, num_heads: int | None = None) -> list:
    """``(path, leaf)`` of a port net in the JAX package's order,
    ``jax.tree.leaves(NetState(params, extra))``: every flax params leaf
    (``convert.to_flax_net``) in sorted-key order, then every extra leaf
    (``batch_stats/...``) in sorted-key order. (One sorted merge would put
    ``batch_stats`` first; sorted keys put ``BasicBlock_10`` before
    ``BasicBlock_2``, as jax does.)"""
    from fedml_tpu_torch.convert import to_flax_net

    params, extra = to_flax_net(state, num_heads)
    return [*_flat_items(params), *_flat_items(extra)]


def _flat_items(tree, prefix=()):
    """(path, leaf) pairs of a nested dict in sorted-key order."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _flat_items(tree[key], prefix + (key,))
        else:
            yield prefix + (key,), tree[key]
