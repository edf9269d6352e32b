"""A service that tracks several sensors on one card:
`BatchTracker(cfg, n_seq).track_batch_async` a batch of frames a call,
`flush()` at the end of the window. At pipeline depth 1 a call dispatches
its batch and resolves the previous one, so a frame's pose comes back from
the next call."""
from __future__ import annotations

from hfvo_tpu_torch.parallel.multiseq import BatchTracker


class Driver:
    def __init__(self, cfg, system: dict, device):
        self.bt = BatchTracker(cfg, system["n_seq"], device, use_local_ba=system["use_local_ba"],
                               pipeline_depth=system["pipeline_depth"])
        self.n_seq = system["n_seq"]
        self.trackers = self.bt.trackers
        self.resolve_s = []  # the host's wait on each resolving call (step_times["resolve"])

    def build_kernels(self, gray, depth) -> None:
        self.bt.warmup(gray, depth)

    def _tag(self, results):
        # Results come S a resolved batch, in sequence order.
        return [(k % self.n_seq, r) for k, r in enumerate(results)]

    def submit(self, frames):
        grays = [f[0] for f in frames]
        depths = [f[1] for f in frames]
        last = self._last_resolve()
        out = self.bt.track_batch_async(grays, depths)
        now = self._last_resolve()
        if now is not None and now is not last:  # this call resolved a batch in the pipe
            self.resolve_s.append(now)
        return self._tag(out)

    def _last_resolve(self):
        tm = getattr(self.bt, "step_times", None)
        return tm["resolve"][-1] if tm and tm["resolve"] else None

    def drain(self):
        return self._tag(self.bt.flush())
