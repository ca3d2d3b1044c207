"""Port's plain NTT (the CPU path of kernel KN) vs seal_embedded_tpu.ops.ntt,
its fused symmetric epilogue and its fused entry from the int64 pte vs
the JAX fused-sym Pallas kernel (after the JAX reduce_pte_i64), and the
plain version of kernel KA, from the signed u, e1 and the int64 pte, vs
the JAX mapping, reduce_pte_i64 and fused-asym Pallas kernel (K6), the
kernels in interpret mode, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seal_embedded_tpu.ckks import asym as jasym
from seal_embedded_tpu.config import PRIMES_27BIT, default_parms
from seal_embedded_tpu.ops import modarith as jma
from seal_embedded_tpu.ops import ntt as jntt
from seal_embedded_tpu.ops import sampling as jsp
from seal_embedded_tpu.ops.kernels.ntt import (ntt_coeff_major_fused_asym,
                                               ntt_coeff_major_fused_sym)
from seal_embedded_tpu_torch.ops import modarith as tma
from seal_embedded_tpu_torch.ops import ntt as tntt
from seal_embedded_tpu_torch.ops.kernels.ntt import (ntt_asym_from_signed,
                                                     ntt_fwd,
                                                     ntt_sym_from_pte)

torch.set_num_threads(2)

_jax_ntt = jax.jit(jntt.ntt, static_argnums=1)


def _tables(n, moduli):
    op, quot = tntt.ntt_tables_stacked(n, moduli)
    return (torch.as_tensor(op.astype(np.int64)),
            torch.as_tensor(quot.astype(np.int64)),
            torch.tensor(moduli, dtype=torch.int64))


@pytest.mark.parametrize("n,nprimes", [(256, 1), (1024, 1), (4096, 3)])
def test_ntt_vs_jax(n, nprimes):
    """Inputs in [0, 4q), with q itself present (reduce_pte's quirk)."""
    moduli = (PRIMES_27BIT[0],) if n == 256 else default_parms(n, nprimes).moduli
    rng = np.random.default_rng(n)
    for q in moduli:
        op, quot = tntt.ntt_tables(n, q)
        jop, jquot = jntt.ntt_tables(n, q)
        assert np.array_equal(op, jop) and np.array_equal(quot, jquot)
        x = rng.integers(0, 4 * q, (3, n), dtype=np.int64)
        x[0, :16] = q
        want = np.asarray(_jax_ntt(jnp.asarray(x.astype(np.uint32)), q))
        got = tntt.ntt(torch.as_tensor(x), q).numpy()
        assert np.array_equal(got, want.astype(np.int64)), q


def test_ntt_limbs_and_wrapper_vs_jax():
    """All limbs in one call, through the KN wrapper's CPU path."""
    n, moduli = 1024, default_parms(4096, 3).moduli
    rng = np.random.default_rng(4)
    x = np.stack([rng.integers(0, q + 1, (2, n), dtype=np.int64)
                  for q in moduli])
    op, quot, q = _tables(n, moduli)
    got = ntt_fwd(torch.as_tensor(x), op, quot, q).numpy()
    for l, ql in enumerate(moduli):
        want = np.asarray(_jax_ntt(jnp.asarray(x[l].astype(np.uint32)), ql))
        assert np.array_equal(got[l], want.astype(np.int64)), l


def test_fused_sym_epilogue_vs_pallas_interpret():
    """c0 = -a * ntt(s) + ntt(x) at L=2, n=256, B=128, against the JAX
    fused-sym kernel (coefficient-major (L, n, B)) in interpret mode.  x
    is nonnegative and below every q, so KN's from-pte entry takes it as
    its pte unchanged."""
    moduli = tuple(int(q) for q in PRIMES_27BIT[:2])
    L, n, B = 2, 256, 128
    rng = np.random.default_rng(0)
    x = rng.integers(0, min(moduli), (n, B), dtype=np.int64)
    a = np.stack([rng.integers(0, q, (n, B), dtype=np.int64) for q in moduli])
    s = np.stack([rng.integers(0, q, n, dtype=np.int64) for q in moduli])
    want = np.asarray(ntt_coeff_major_fused_sym(
        jnp.asarray(np.stack([x] * L).astype(np.uint32)),
        jnp.asarray(a.astype(np.uint32)), jnp.asarray(s.astype(np.uint32)),
        moduli, interpret=True))

    op, quot, q = _tables(n, moduli)
    mods = tma.modpack(moduli)
    pte = torch.as_tensor(x.T.copy())                           # (B, n)
    at = torch.as_tensor(a).transpose(1, 2).contiguous()        # (L, B, n)
    s_op = torch.as_tensor(s)
    s_quot = tma.shoup_quotient(s_op, q[:, None])
    plain = tntt.sym_epilogue(
        tntt.ntt_limbs(pte.expand(L, B, n), op, quot, q), at, s_op, s_quot,
        q)
    wrapped = ntt_sym_from_pte(pte, at, s_op, s_quot, op, quot, q, mods.r0,
                               mods.r1)
    assert torch.equal(plain, wrapped)
    assert np.array_equal(plain.transpose(1, 2).numpy(),
                          want.astype(np.int64))


def edge_pte(rng, moduli, B, n):
    """int64 (B, n) plaintext + error: random values of every magnitude,
    with 0, +-k q of each modulus, +-(2^63 - 1), INT64_MIN and the
    magnitudes at the encode's overflow edge (the largest doubles below
    2^63, 2^62, 2^53 + 1) at the head of the rows."""
    big = np.iinfo(np.int64)
    x = rng.integers(big.min, big.max, (B, n), dtype=np.int64,
                     endpoint=True)
    x[:, n // 2:] >>= rng.integers(0, 63, (B, n - n // 2))
    edges = [0, 1, -1, big.max, -big.max, big.min, 2 ** 63 - 1024,
             -(2 ** 63 - 1024), 2 ** 62, -(2 ** 62), 2 ** 53 + 1,
             -(2 ** 53 + 1)]
    for q in moduli:
        for k in (1, 2, 12345, (2 ** 63 - 1) // q):
            edges += [k * q, -k * q, k * q + 1, -k * q - 1]
    flat = x.reshape(-1)
    flat[:len(edges)] = edges
    return x


def _from_pte_case(moduli, B, n, seed):
    rng = np.random.default_rng(seed)
    pte = edge_pte(rng, moduli, B, n)
    a = np.stack([rng.integers(0, q, (B, n), dtype=np.int64) for q in moduli])
    s = np.stack([rng.integers(0, q, n, dtype=np.int64) for q in moduli])
    return pte, a, s


def _from_pte_port(pte, a, s, moduli):
    """The port's fused entry on CPU tensors (its plain version)."""
    n = pte.shape[1]
    op, quot, q = _tables(n, moduli)
    mods = tma.modpack(moduli)
    s_op = torch.as_tensor(s)
    s_quot = tma.shoup_quotient(s_op, q[:, None])
    return ntt_sym_from_pte(torch.as_tensor(pte), torch.as_tensor(a), s_op,
                            s_quot, op, quot, q, mods.r0, mods.r1)


def _from_pte_jax(pte, a, s, moduli):
    """JAX reduce_pte_i64 per limb, then the fused-sym Pallas kernel in
    interpret mode, coefficient-major; returned as (L, B, n)."""
    red = np.stack([np.asarray(jma.reduce_pte_i64(jnp.asarray(pte), q))
                    for q in moduli])                            # (L, B, n)
    want = ntt_coeff_major_fused_sym(
        jnp.asarray(red.transpose(0, 2, 1).astype(np.uint32)),
        jnp.asarray(a.transpose(0, 2, 1).astype(np.uint32)),
        jnp.asarray(s.astype(np.uint32)), moduli, interpret=True)
    return np.asarray(want).astype(np.int64).transpose(0, 2, 1)


@pytest.mark.parametrize("nprimes", [1, 2])
def test_ntt_sym_from_pte_vs_pallas_interpret(nprimes):
    """c0 = -a * ntt(s) + ntt(reduce_pte(pte)) on edge pte values, at
    (L, B, n) = (1 or 2, 128, 256): the plain version of KN's from-pte
    entry against the JAX reduce_pte_i64 + fused-sym kernel, and against
    reduce_pte_i64, the unfused wrapper and the epilogue."""
    moduli = tuple(int(q) for q in PRIMES_27BIT[:nprimes])
    pte, a, s = _from_pte_case(moduli, 128, 256, 20 + nprimes)
    got = _from_pte_port(pte, a, s, moduli)
    assert np.array_equal(got.numpy(), _from_pte_jax(pte, a, s, moduli))
    op, quot, q = _tables(256, moduli)
    mods = tma.modpack(moduli)
    red = tma.reduce_pte_i64(torch.as_tensor(pte)[None],
                             tma.Mod(*(f[:, None, None] for f in mods)))
    assert bool((red == q[:, None, None]).any())      # the x < 0 quirk ran
    s_op = torch.as_tensor(s)
    assert torch.equal(got, tntt.sym_epilogue(
        ntt_fwd(red, op, quot, q), torch.as_tensor(a), s_op,
        tma.shoup_quotient(s_op, q[:, None]), q))


def test_ntt_sym_from_pte_wrapper_checks():
    moduli = tuple(int(q) for q in PRIMES_27BIT[:2])
    pte, a, s = (torch.as_tensor(t) for t in _from_pte_case(moduli, 2, 64, 3))
    op, quot, q = _tables(64, moduli)
    mods = tma.modpack(moduli)
    args = [pte, a, s, s, op, quot, q, mods.r0, mods.r1]
    ntt_sym_from_pte(*args)
    for i, bad in ((0, pte[:1]), (0, pte.to(torch.int32)), (1, a[:, :, :32]),
                   (2, s[:1]), (7, mods.r0[:1]),
                   (1, a.transpose(1, 2).contiguous().transpose(1, 2))):
        with pytest.raises(ValueError):
            ntt_sym_from_pte(*args[:i], bad, *args[i + 1:])


def test_ntt_wrapper_checks():
    op, quot, q = _tables(256, (PRIMES_27BIT[0],))
    x = torch.zeros((1, 2, 256), dtype=torch.int64)
    with pytest.raises(ValueError):
        ntt_fwd(x.to(torch.int32), op, quot, q)
    with pytest.raises(ValueError):
        ntt_fwd(x[:, :, :128], op, quot, q)
    with pytest.raises(ValueError):
        ntt_fwd(x, op[:, :128], quot, q)
    with pytest.raises(ValueError):
        ntt_fwd(x.transpose(1, 2).contiguous().transpose(1, 2), op, quot, q)


def _asym_case(moduli, B, n, seed):
    """Signed u (every value of {-1, 0, 1}) and e1 (+-63 and 0 at the head
    of every row), edge int64 pte, all (B, n); pk0, pk1 (L, n) in [0, q)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(-1, 2, (B, n), dtype=np.int64)
    u[:, :3] = [-1, 0, 1]
    e1 = rng.integers(-63, 64, (B, n), dtype=np.int64)
    e1[:, :3] = [-63, 0, 63]
    pte = edge_pte(rng, moduli, B, n)
    pk = [np.stack([rng.integers(0, q, n, dtype=np.int64) for q in moduli])
          for _ in range(2)]
    return (u, e1, pte), pk


def _asym_args(rows, pk, moduli):
    """The KA wrapper's arguments from the numpy inputs."""
    n = rows[0].shape[1]
    op, quot, q = _tables(n, moduli)
    mods = tma.modpack(moduli)
    pairs = []
    for p in pk:
        p = torch.as_tensor(p)
        pairs += [p, tma.shoup_quotient(p, q[:, None])]
    return (*map(torch.as_tensor, rows), op, quot, q, mods.r0, mods.r1,
            *pairs)


def _asym_jax(rows, pk, moduli):
    """The JAX package's asym step (ckks/asym.py:135-163): u through
    ternary_to_modq_any, e1 through _signed_to_modq, pte through
    reduce_pte_i64, per limb, then the fused-asym kernel in interpret mode,
    coefficient-major; returned as (L, B, n) each."""
    u, e1, pte = rows
    mapped = [np.stack([np.asarray(f(jnp.asarray(x), q)) for q in moduli])
              for f, x in ((jsp.ternary_to_modq_any, u.astype(np.int32)),
                           (jasym._signed_to_modq, e1.astype(np.int32)),
                           (jma.reduce_pte_i64, pte))]
    cm = [jnp.asarray(x.transpose(0, 2, 1).astype(np.uint32)) for x in mapped]
    c0, c1 = ntt_coeff_major_fused_asym(
        *cm, *(jnp.asarray(p.astype(np.uint32)) for p in pk), moduli,
        interpret=True)
    return [np.asarray(c).astype(np.int64).transpose(0, 2, 1)
            for c in (c0, c1)]


def test_ntt_asym_plain_vs_pallas_interpret():
    """c0 = pk0 * ntt(u) + ntt(reduce_pte(pte)), c1 = pk1 * ntt(u) +
    ntt(e1) at L=2, n=256, B=128 from the signed u, e1 and edge int64 pte:
    KA's wrapper (its plain version on the CPU) against the JAX mapping,
    reduce_pte_i64 and fused-asym kernel in interpret mode."""
    moduli = tuple(int(q) for q in PRIMES_27BIT[:2])
    rows, pk = _asym_case(moduli, 128, 256, 5)
    args = _asym_args(rows, pk, moduli)
    got = ntt_asym_from_signed(*args)
    assert torch.equal(got[0], tntt.ntt_asym_from_signed_plain(*args)[0])
    for name, g, want in zip(("c0", "c1"), got, _asym_jax(rows, pk, moduli)):
        assert np.array_equal(g.numpy(), want), name


def test_asym_epilogue_matches_barrett():
    """The Shoup combine equals add_mod(mul_mod(pk, nu), other) (the JAX
    package's unfused asym epilogue) on values up to q - 1."""
    moduli = default_parms(4096, 3).moduli
    L, B, n = 3, 2, 64
    rng = np.random.default_rng(9)
    q = torch.tensor(moduli, dtype=torch.int64)
    qv = q[:, None, None]
    nu, other = (torch.as_tensor(np.stack([rng.integers(0, m, (B, n))
                                           for m in moduli])) for _ in range(2))
    nu[:, :, 0] = qv[:, :, 0] - 1
    pk = torch.as_tensor(np.stack([rng.integers(0, m, n) for m in moduli]))
    got = tntt.asym_epilogue(nu, other, pk, tma.shoup_quotient(pk, q[:, None]),
                             q)
    mods = tma.modpack(moduli)
    mb = tma.Mod(*(f[:, None, None] for f in mods))
    want = tma.add_mod(tma.mul_mod(pk[:, None, :], nu, mb), other, mb)
    assert torch.equal(got, want)


def test_ntt_asym_wrapper_checks():
    """The KA wrapper refuses an int32 row, (L, B, n) rows, a pk pair of
    the wrong shape and a non-contiguous row."""
    moduli = tuple(int(q) for q in PRIMES_27BIT[:2])
    rows, pk = _asym_case(moduli, 2, 64, 1)
    args = list(_asym_args(rows, pk, moduli))
    u = args[0]
    ntt_asym_from_signed(*args)
    for i, bad in ((0, u.to(torch.int32)), (0, u[None].expand(2, 2, 64)),
                   (1, args[1][None].expand(2, 2, 64).contiguous()),
                   (8, args[8][:, :32]), (11, args[11][:1]), (6, args[6][:1]),
                   (2, args[2].t().contiguous().t())):
        with pytest.raises(ValueError):
            ntt_asym_from_signed(*args[:i], bad, *args[i + 1:])


_jax_intt = jax.jit(jntt.intt, static_argnums=1)
_jax_otf = jax.jit(jntt.ntt_otf, static_argnums=1)
_jax_lazy = jax.jit(jntt.intt_lazy_with_tables, static_argnums=3)


@pytest.mark.parametrize("n,q", [(64, PRIMES_27BIT[0]),
                                 (1024, default_parms(4096, 3).moduli[1])])
def test_inverse_and_otf_vs_jax(n, q):
    """intt, the lazy INTT with the reference's fast-root file tables,
    the OTF forward NTT and the round trip, against ops/ntt.py."""
    from seal_embedded_tpu.config import find_ntt_root
    from seal_embedded_tpu.io import serialize as jser
    from seal_embedded_tpu_torch.io import serialize as tser

    logn = n.bit_length() - 1
    w = find_ntt_root(n, q)
    pairs = tser.intt_fast_root_table(n, logn, q, w)
    assert np.array_equal(pairs, jser.intt_fast_root_table(n, logn, q, w))
    assert np.array_equal(tser.intt_root_table(n, logn, q, w),
                          jser.intt_root_table(n, logn, q, w))
    assert tntt.intt_lazy_consts(n, q) == jntt.intt_lazy_consts(n, q)
    for a, b in zip(tntt.intt_tables(n, q), jntt.intt_tables(n, q)):
        assert np.array_equal(a, b)

    rng = np.random.default_rng(n + 1)
    x = rng.integers(0, q, (3, n), dtype=np.int64)
    x[0, :4] = q - 1
    x[1, :4] = 0
    jx = jnp.asarray(x.astype(np.uint32))
    xt = torch.as_tensor(x)
    want = np.asarray(_jax_intt(jx, q)).astype(np.int64)
    assert np.array_equal(tntt.intt(xt, q).numpy(), want)

    op = jnp.asarray(pairs[0::2])
    quot = jnp.asarray(pairs[1::2])
    got = tntt.intt_lazy_with_tables(
        xt, torch.as_tensor(pairs[0::2].astype(np.int64)),
        torch.as_tensor(pairs[1::2].astype(np.int64)), q).numpy()
    assert np.array_equal(got, np.asarray(_jax_lazy(jx, op, quot, q)))
    assert np.array_equal(got, want)

    otf = tntt.ntt_otf(xt, q)
    assert np.array_equal(otf.numpy(), np.asarray(_jax_otf(jx, q)))
    assert torch.equal(otf, tntt.ntt(xt, q))
    assert torch.equal(tntt.intt(tntt.ntt(xt, q), q), xt)
    assert torch.equal(tntt.pointwise_mul_mod(otf, xt, q),
                       tma.mul_mod(otf, xt, q))
