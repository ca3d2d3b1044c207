"""limb_wait_ms (ms): the host's wait for a call's limbs to reach host
memory, the sum of its limbs' ``wait_ms`` (ckks/stream.py ``_fetch``),
mean over the window's calls: the card's and the copies' time the host
could not hide."""


def read(obs):
    if not obs.calls:
        return None
    return sum(c.wait_ms for c in obs.calls) / len(obs.calls)
