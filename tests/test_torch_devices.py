"""The port's constructors and factories put their tensors on the card
unless told otherwise: with no `device`, they land on CUDA where a card is
present, and raise where there is none (nothing falls back to the CPU).
The same calls with device="cpu" build on the CPU."""

import numpy as np
import pytest
import torch

from seal_embedded_tpu_torch import convert, sweep
from seal_embedded_tpu_torch.ckks import asym as tasym
from seal_embedded_tpu_torch.ckks import limbwise as tlw
from seal_embedded_tpu_torch.ckks import sym as tsym
from seal_embedded_tpu_torch.ckks.asym import AsymEncryptor
from seal_embedded_tpu_torch.ckks.fast import (EncryptorBase, SymEncryptor,
                                               make_fused_encryptor)
from seal_embedded_tpu_torch.config import Parms
from seal_embedded_tpu_torch.ops.encode import make_decoder
from seal_embedded_tpu_torch.ops.kernels import calibrate as kcal
from seal_embedded_tpu_torch.parallel import comm, dryrun, launch
from seal_embedded_tpu_torch.parallel import limbwise as plw
from seal_embedded_tpu_torch.parallel import mesh as pmesh
from seal_embedded_tpu_torch.parallel import multihost as pmh
from seal_embedded_tpu_torch.parallel.coeff_ntt import ntt_coeff_sharded

torch.set_num_threads(2)

P = Parms(degree=64, moduli=(1053818881, 1053360129), scale=2.0 ** 20)
PK = np.ones((2, 64), dtype=np.uint32)


def _device_of(made):
    """The device an object of the cases below keeps its tensors on."""
    if isinstance(made, torch.Tensor):
        return made.device
    if isinstance(made, pmesh.DeviceMesh):
        return torch.device(made.device_type)
    if isinstance(made, torch.nn.Module):
        return made.q.device
    if isinstance(made, tuple):
        return made[0].device
    if isinstance(made, dict):          # an asym factory's output
        return made["c1"].device
    return made.device                  # a compiled factory (graphs.Graphed)


def _asym_inputs(d):
    dev = d.get("device", "cuda")
    return (torch.zeros((1, 32), device=dev), PK, PK,
            torch.zeros((1, 16), dtype=torch.int64, device=dev))


CASES = {
    "EncryptorBase": lambda **d: EncryptorBase(P, **d),
    "SymEncryptor": lambda **d: SymEncryptor(P, **d),
    "LimbscanEncryptor": lambda **d: tlw.LimbscanEncryptor(P, **d),
    "AsymEncryptor": lambda **d: AsymEncryptor(P, PK, PK, **d),
    "make_limbscan_encryptor": lambda **d: tlw.make_limbscan_encryptor(P,
                                                                       **d),
    "make_sym_encryptor": lambda **d: tsym.make_sym_encryptor(P, **d),
    "make_from_pte_encryptor": lambda **d: tlw.make_from_pte_encryptor(P,
                                                                       **d),
    "make_fused_encryptor": lambda **d: make_fused_encryptor(P, **d),
    "make_asym_encryptor": lambda **d: tasym.make_asym_encryptor(P, **d)(
        *_asym_inputs(d)),
    "make_fused_asym_encryptor": lambda **d: tasym.make_fused_asym_encryptor(
        P, **d)(*_asym_inputs(d)),
    "mix_input": lambda **d: kcal.mix_input(**d),
    "run_mix": lambda **d: kcal.run_mix("keccak", 8, **d)(),
    "make_c1_expander": lambda **d: tlw.make_c1_expander(P, **d),
    "make_decryptor": lambda **d: tsym.make_decryptor(P, **d),
    "make_decoder": lambda **d: make_decoder(P, **d),
    "pk_to_device": lambda **d: convert.pk_to_device(PK, PK, **d),
    "asym_state_to_device": lambda **d: convert.asym_state_to_device(
        np.zeros((1, 8)), np.zeros((1, 16)), **d),
    "state_to_device": lambda **d: convert.state_to_device(
        np.zeros((1, 8)), np.zeros(64), np.zeros((1, 16)),
        np.zeros((1, 16)), **d),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_default_device_is_cuda(name):
    make = CASES[name]
    assert _device_of(make(device="cpu")).type == "cpu"
    if torch.cuda.is_available():
        assert _device_of(make()).type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()


def _sym_inputs(mesh):
    dev = pmesh.mesh_device(mesh)
    return (torch.zeros((1, 32), device=dev),
            torch.zeros(64, dtype=torch.int64, device=dev),
            torch.zeros((1, 16), dtype=torch.int64, device=dev),
            torch.zeros((1, 16), dtype=torch.int64, device=dev))


def _limb_sym(**t):
    m = pmesh.make_mesh(**t)
    return plw.make_limb_sharded_encryptor(m, P)(*_sym_inputs(m))


def _limb_asym(**t):
    m = pmesh.make_mesh(**t)
    values, _, seeds, _ = _sym_inputs(m)
    return plw.make_asym_limb_sharded_encryptor(m, P)(values, PK, PK, seeds)


def _sym_sharded(**t):
    m = pmesh.make_mesh(**t)
    return pmesh.sym_encrypt_sharded(m, P)(*_sym_inputs(m))


def _multihost(**t):
    m = pmh.make_host_mesh(**t)
    return pmh.make_multihost_encryptor(m, P)(*_sym_inputs(m))


def _coeff_ntt(**t):
    m = pmesh.make_mesh(**t)
    return ntt_coeff_sharded(m, 64, P.moduli[0])(_sym_inputs(m)[1][None])


# The scale-out entry points take the device type of their mesh; those
# that take a mesh run on a one-rank one.
MESH_CASES = {
    "make_mesh": pmesh.make_mesh, "make_host_mesh": pmh.make_host_mesh,
    "make_limb_sharded_encryptor": _limb_sym,
    "make_asym_limb_sharded_encryptor": _limb_asym,
    "sym_encrypt_sharded": _sym_sharded,
    "make_multihost_encryptor": _multihost, "ntt_coeff_sharded": _coeff_ntt,
}


@pytest.fixture
def one_rank(tmp_path):
    with launch.process_group(1, 0, str(tmp_path / "store"), "cpu"):
        yield


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_scale_out_default_device_is_cuda(one_rank, name):
    make = MESH_CASES[name]
    assert _device_of(make(device_type="cpu")).type == "cpu"
    if torch.cuda.is_available():
        assert _device_of(make()).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            make()


def test_rank_body_device_follows_the_group(one_rank):
    """rank_body takes no device: it reads the joined group's backend."""
    assert comm.group_device_type() == "cpu"


def test_spawn_and_init_distributed_default_to_cuda():
    assert launch.spawn(1, dryrun.rank_body, ({},), "cpu", 120) == [{}]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            launch.spawn(1, dryrun.rank_body, ({},))
        with pytest.raises(RuntimeError):
            pmh.init_distributed("localhost:1", 2, 0)


def test_sweep_default_device_is_cuda():
    assert sweep.run_sweep(64, 1, quick=True, device="cpu").ok
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            sweep.run_sweep(64, 1, quick=True)
