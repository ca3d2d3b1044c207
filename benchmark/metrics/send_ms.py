"""send_ms (ms): the program's send loop as the receiver sees it: a call's
sum over limbs of the time from the limb's first chunk handed to the send
callback to its last (harness.Sink, two host-clock reads a limb), mean
over the window's calls.  Silent where the traffic sends nothing."""


def read(obs):
    if not obs.calls or "send" not in obs.mix:
        return None
    return sum(c.send_ms for c in obs.calls) / len(obs.calls)
