"""idle_share (%): the card's idle share over the traced device segment:
1 - the union of its device intervals (kernels and copies) / the
segment's window, as perf_stages.timeline takes it."""


def read(obs):
    seg = obs.segment
    if seg is None or seg.window_us <= 0:
        return None
    return 100.0 * (1.0 - seg.busy_us() / seg.window_us)
