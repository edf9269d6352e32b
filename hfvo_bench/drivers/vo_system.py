"""One live sensor: `VOSystem(cfg).track_rgbd`, a frame a call, the call
ending in the port's device-to-host sync (the main path, as
`python -m hfvo_tpu_torch.cli` runs it)."""
from __future__ import annotations

from hfvo_tpu_torch.system import VOSystem


class Driver:
    def __init__(self, cfg, system: dict, device):
        self.vo = VOSystem(cfg, device, use_local_ba=system["use_local_ba"],
                           use_loop_closing=system["use_loop_closing"])
        self.vo.tracker.auto_reset = system["auto_reset"]
        self.trackers = [self.vo.tracker]
        self.resolve_s = []  # no pipelined resolve on this path

    def build_kernels(self, gray, depth) -> None:
        self.vo.tracker.warmup(gray, depth)

    def submit(self, frames):
        """frames: [(gray, depth, timestamp)] of the one sequence ->
        [(sequence, TrackResult)] resolved by this call."""
        ((gray, depth, ts),) = frames
        return [(0, self.vo.track_rgbd(gray, depth, ts))]

    def drain(self):
        return []
