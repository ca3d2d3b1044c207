"""host_ms.small (ms): the API's own host work a call at a small batch,
where it sets the call's time: each window call's host-clock time less
its limbs' copy waits (``wait_ms``), mean over the window's calls."""


def read(obs):
    if not obs.calls:
        return None
    return sum(c.ms - c.wait_ms for c in obs.calls) / len(obs.calls)
