"""Host ms of the keyframe path (every `kf_*` stage, `local_ba` and
`loop_detect`) a frame, over the frames after the traced slice."""


def read(ctx):
    n = ctx.host["frames"]
    if not n:
        return None
    s = sum(v[0] for k, v in ctx.host["stages"].items()
            if k.startswith("kf_") or k in ("local_ba", "loop_detect"))
    return 1e3 * s / n
