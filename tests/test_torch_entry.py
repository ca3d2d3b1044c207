"""The port's entry (seal_embedded_tpu_torch/entry.py) against
__graft_entry__.entry: the same example inputs, and the jitted JAX step's
outputs equal bit for bit to the port's CPU path."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

import __graft_entry__ as jentry
from seal_embedded_tpu_torch import entry as tentry

REPO = Path(__file__).resolve().parents[1]

torch.set_num_threads(2)


def test_entry_vs_jax():
    jfn, jargs = jentry.entry()
    fn, args = tentry.entry(device="cpu")
    assert len(args) == len(jargs)
    for got, want in zip(args, jargs):
        assert got.device.type == "cpu"
        assert np.array_equal(got.numpy(), np.asarray(want))
    want = jax.jit(jfn)(*jargs)
    got = fn(*args)
    assert set(got) == set(want)
    for key, w in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(w)), key
    assert got["ok"].all()


def test_entry_imports_no_jax():
    code = ("import sys\n"
            "import seal_embedded_tpu_torch.entry\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            "\n       or m == 'seal_embedded_tpu'"
            "\n       or m.startswith('seal_embedded_tpu.')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
