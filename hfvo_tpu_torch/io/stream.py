"""Live RGB-D stream ingest: the host's equivalent of the ROS driver.

Port of `hfvo_tpu.io.stream` (numpy and stdlib, copied): the same wire
format, so a publisher of either package feeds a server of the other, and
the same synchronizer, so both emit the same pairs and drop counts.

(reference: Examples/ROS/ORB_SLAM2/src/ros_rgbd.cc — two message_filters
subscribers on the RGB and registered-depth topics joined by an
ApproximateTime(10) synchronizer whose callback feeds System::TrackRGBD
with the RGB header timestamp, ros_rgbd.cc:66-75,112; on shutdown the node
saves the keyframe trajectory, ros_rgbd.cc:81-83.)

A GPU host has no ROS, so the transport is a plain TCP socket carrying
length-prefixed numpy frames (`FrameStreamServer` / `send_frame`), and the
synchronizer is a faithful standalone reimplementation of the
message_filters *ApproximateTime* policy for two channels
(`ApproximateTimeSync`): per-channel bounded deques, and a pairing rule
that only emits a (rgb, depth) set once it is provably optimal — each
member is the closest counterpart to the other, and a later message on
each queue (or a full queue) proves no better candidate can still arrive.
Messages older than an emitted set are dropped, preserving the policy's
monotonic-output guarantee.
"""
from __future__ import annotations

import socket
import struct
import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

# --------------------------------------------------------------------------
# Approximate-time synchronization (message_filters semantics, 2 channels)
# --------------------------------------------------------------------------


@dataclass
class _Msg:
    stamp: float
    data: np.ndarray


class ApproximateTimeSync:
    """Two-channel approximate-time synchronizer.

    Mirrors ``message_filters::sync_policies::ApproximateTime`` as used by
    the reference driver (queue size 10, ros_rgbd.cc:72-74): messages are
    queued per channel; a pivot pair is emitted when it is *mutually
    nearest* — i.e. for the head candidates (a, b), no not-yet-seen message
    can beat |a.stamp - b.stamp| on either channel. That is proven either
    by the next queued message on a channel being farther from the other
    member, or by the queue being full (older entries are evicted, so a
    better partner can no longer be formed). Emission is monotonic:
    everything at or before an emitted pair is discarded.

    ``max_interval`` (seconds) optionally rejects pairs farther apart than
    the sensor's frame interval, like the policy's setMaxIntervalDuration.
    """

    def __init__(
        self,
        callback: Callable[[float, np.ndarray, np.ndarray], None],
        queue_size: int = 10,
        max_interval: Optional[float] = None,
    ):
        self.callback = callback
        self.queue_size = queue_size
        self.max_interval = max_interval
        self._q = (deque(), deque())  # rgb, depth
        self._last_emitted = -np.inf
        self.n_emitted = 0
        self.n_dropped = 0

    def push_rgb(self, stamp: float, data: np.ndarray) -> None:
        self._push(0, stamp, data)

    def push_depth(self, stamp: float, data: np.ndarray) -> None:
        self._push(1, stamp, data)

    def _push(self, ch: int, stamp: float, data: np.ndarray) -> None:
        if stamp <= self._last_emitted:
            self.n_dropped += 1  # would violate monotonic output
            return
        q = self._q[ch]
        # Insert keeping per-channel stamp order (UDP-ish reordering).
        msg = _Msg(float(stamp), data)
        if q and q[-1].stamp > msg.stamp:
            idx = next(
                (i for i, m in enumerate(q) if m.stamp > msg.stamp), len(q)
            )
            q.insert(idx, msg)
        else:
            q.append(msg)
        if len(q) > self.queue_size:
            q.popleft()
            self.n_dropped += 1
        self._try_emit()

    def flush(self) -> None:
        """End of stream: no future message can improve any pairing, so
        emit the remaining mutually-nearest pairs (the ROS policy simply
        leaves them queued; a finite stream driver wants them delivered)."""
        self._try_emit(final=True)

    def _try_emit(self, final: bool = False) -> None:
        qa, qb = self._q
        while qa and qb:
            # Candidate pair: heads matched to their nearest counterpart.
            a = qa[0]
            # Nearest b to a:
            jb = int(np.argmin([abs(m.stamp - a.stamp) for m in qb]))
            b = qb[jb]
            # Is a also the nearest a to b among queued a's?
            ja = int(np.argmin([abs(m.stamp - b.stamp) for m in qa]))
            if ja != 0:
                # An older-than-best a exists in front; those heads can
                # never pair better than (qa[ja], b) — drop them.
                for _ in range(ja):
                    qa.popleft()
                    self.n_dropped += 1
                continue
            dt = abs(a.stamp - b.stamp)
            # Optimality proof: a later message on each channel bounds any
            # future candidate, or the queue is full (no better partner can
            # survive the eviction window), or the stream ended.
            a_settled = final or (
                len(qb) > jb + 1 and abs(qb[jb + 1].stamp - a.stamp) >= dt
            ) or len(qb) == self.queue_size
            b_settled = final or (
                len(qa) > 1 and abs(qa[1].stamp - b.stamp) >= dt
            ) or len(qa) == self.queue_size
            if not (a_settled and b_settled):
                return  # wait for more evidence
            # Drop everything strictly older than the emitted set.
            for _ in range(jb):
                qb.popleft()
                self.n_dropped += 1
            qa.popleft()
            qb.popleft()
            if self.max_interval is not None and dt > self.max_interval:
                self.n_dropped += 2
                continue
            self._last_emitted = max(a.stamp, b.stamp)
            self.n_emitted += 1
            # RGB header timestamp keys the track call (ros_rgbd.cc:112).
            self.callback(a.stamp, a.data, b.data)


# --------------------------------------------------------------------------
# Socket transport (length-prefixed numpy frames)
# --------------------------------------------------------------------------

_MAGIC = b"HFVO"
_HDR = struct.Struct("<4sBBdHHI")  # magic, channel, dtype-code, stamp, h, w, nbytes
_DTYPES = {0: np.uint8, 1: np.uint16, 2: np.float32}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}
CH_RGB, CH_DEPTH, CH_EOF = 0, 1, 255


def send_frame(
    sock: socket.socket, channel: int, stamp: float, img: Optional[np.ndarray]
) -> None:
    """Publish one frame (client side; analog of a ROS topic publish)."""
    if channel == CH_EOF or img is None:
        sock.sendall(_HDR.pack(_MAGIC, CH_EOF, 0, stamp, 0, 0, 0))
        return
    img = np.ascontiguousarray(img)
    code = _DTYPE_CODES[img.dtype]
    h, w = img.shape[:2]
    payload = img.tobytes()
    sock.sendall(
        _HDR.pack(_MAGIC, channel, code, stamp, h, w, len(payload)) + payload
    )


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("stream closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


class FrameStreamServer:
    """Accept one publisher connection and feed the synchronizer.

    The callback receives ``(stamp, gray_or_rgb, depth)`` exactly like the
    reference's ``ImageGrabber::GrabRGBD`` receives the synced message pair
    and forwards it to ``TrackRGBD`` (ros_rgbd.cc:89-112).
    """

    def __init__(
        self,
        callback: Callable[[float, np.ndarray, np.ndarray], None],
        host: str = "127.0.0.1",
        port: int = 0,
        queue_size: int = 10,
        max_interval: Optional[float] = None,
    ):
        self.sync = ApproximateTimeSync(
            callback, queue_size=queue_size, max_interval=max_interval
        )
        self._listener = socket.create_server((host, port))
        self.port = self._listener.getsockname()[1]
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        try:
            conn, _ = self._listener.accept()
            with conn:
                while True:
                    hdr = _recv_exact(conn, _HDR.size)
                    magic, ch, code, stamp, h, w, nbytes = _HDR.unpack(hdr)
                    if magic != _MAGIC:
                        raise ValueError("bad frame magic")
                    if ch == CH_EOF:
                        self.sync.flush()
                        break
                    flat = np.frombuffer(
                        _recv_exact(conn, nbytes), dtype=_DTYPES[code]
                    )
                    img = flat.reshape(h, w, -1) if flat.size > h * w else (
                        flat.reshape(h, w)
                    )
                    if ch == CH_RGB:
                        self.sync.push_rgb(stamp, img)
                    elif ch == CH_DEPTH:
                        self.sync.push_depth(stamp, img)
        except (ConnectionError, OSError, ValueError):
            pass  # publisher vanished: same as a ROS node dropping off
        finally:
            self._done.set()
            self._listener.close()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the publisher sends EOF or disconnects."""
        return self._done.wait(timeout)
