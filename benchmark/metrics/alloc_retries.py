"""alloc_retries (count): the caching allocator's retries over the window
(``torch.cuda.memory_stats()["num_alloc_retries"]``): each a synchronize
and a release of cached blocks inside a call."""


def read(obs):
    return obs.alloc_retries
