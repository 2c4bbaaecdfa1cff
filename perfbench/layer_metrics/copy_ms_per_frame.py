"""Device time of the copies between host and card (memcpy events of the
profiler's trace) in the traced slice, per frame the slice completed."""


def read(ctx):
    t = ctx["trace"].seconds(cat="gpu_memcpy")
    frames = ctx["work"]["frames"]
    return 1e3 * t / frames if t > 0 and frames else None
