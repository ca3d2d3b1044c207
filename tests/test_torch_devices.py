"""The port's constructors and factories put their tensors on the card
unless told otherwise: with no `device`, they land on CUDA where a card is
present, and raise where there is none (nothing falls back to the CPU).
The same calls with device="cpu" build on the CPU."""

import numpy as np
import pytest
import torch

from seal_embedded_tpu_torch import convert
from seal_embedded_tpu_torch.ckks import limbwise as tlw
from seal_embedded_tpu_torch.ckks import sym as tsym
from seal_embedded_tpu_torch.ckks.asym import AsymEncryptor
from seal_embedded_tpu_torch.ckks.fast import EncryptorBase, SymEncryptor
from seal_embedded_tpu_torch.config import Parms

torch.set_num_threads(2)

P = Parms(degree=64, moduli=(1053818881, 1053360129), scale=2.0 ** 20)
PK = np.ones((2, 64), dtype=np.uint32)
SHARE = torch.zeros((1, 16), dtype=torch.int64)


def _device_of(made):
    """The device an object of the cases below keeps its tensors on."""
    if isinstance(made, torch.nn.Module):
        return made.q.device
    if isinstance(made, tuple):
        return made[0].device
    if isinstance(made, dict):          # an expander's output
        return made["c1"].device
    return made.__self__.q.device       # make_from_pte_encryptor's method


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
    "make_c1_expander": lambda **d: dict(zip(
        ("c1", "ok"), tlw.make_c1_expander(P, **d)(SHARE))),
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
