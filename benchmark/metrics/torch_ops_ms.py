"""torch_ops_ms (ms): device time a call of every kernel that is not the
port's own (names not starting keccak_, ntt_kernel, ntt_asym_kernel,
encode_ or calib_) and not a copy or memset: the torch code around the
kernels (ops/sampling.py's rank-select, ops/modarith.py's barrett32, the
ternary loop), from the traced device segment."""

PORT_KERNELS = ("keccak_", "ntt_kernel", "ntt_asym_kernel", "encode_",
                "calib_")


def read(obs):
    from benchmark.trace import is_copy, kernel_name
    seg = obs.segment
    if seg is None or not seg.calls:
        return None
    us = seg.time_us(lambda name: not is_copy(name) and not kernel_name(
        name).startswith(PORT_KERNELS))
    return us * 1e-3 / seg.calls
