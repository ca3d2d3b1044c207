"""host_ms.batch (ms): the API's own host work a call at B = 1024 (seed
packing, uploads, replays, views): each window call's host-clock time
less its limbs' copy waits (``wait_ms``), mean over the window's calls."""


def read(obs):
    if not obs.calls:
        return None
    return sum(c.ms - c.wait_ms for c in obs.calls) / len(obs.calls)
