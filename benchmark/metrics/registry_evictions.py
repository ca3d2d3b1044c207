"""registry_evictions (count): graphs evicted by the card's registry
(``graphs.registry_for(dev).evictions``) over the window.  0 in a steady
state; an eviction is a capture again inside the timing."""


def read(obs):
    return obs.evictions
