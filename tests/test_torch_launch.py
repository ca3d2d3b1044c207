"""The port's rank launcher: a rank's exception reaches the caller, a run
past its time limit is killed and raises, and the CUDA backend is asked
for only with a card."""

import multiprocessing as mp

import pytest
import torch

from seal_embedded_tpu_torch.config import PRIMES_27BIT, Parms
from seal_embedded_tpu_torch.parallel import comm, dryrun, launch

P = Parms(64, PRIMES_27BIT[:2], 2.0 ** 20)


@pytest.mark.parametrize("mesh,B,error", [
    ((3, 1), 3, "needs 3 ranks"),             # a mesh the group cannot hold
    ((1, 2), 3, "does not split evenly")])    # B = 3 over 2 ranks
def test_rank_exception_reaches_caller(mesh, B, error):
    """A ValueError in every rank reaches the caller with the rank's
    traceback."""
    bad = {"bad": {"kind": "sym", "mesh": mesh, "parms": P, "B": B,
                   "seed": 0}}
    with pytest.raises(RuntimeError, match=error):
        launch.spawn(2, dryrun.rank_body, (bad,), "cpu", 120)
    assert not mp.active_children()


def test_timeout_kills_the_ranks():
    """No rank finishes within 0.3 s (a child needs longer just to import
    torch): spawn kills them and raises."""
    plan = {"sym": {"kind": "sym", "mesh": (1, 1), "parms": P, "B": 1,
                    "seed": 0}}
    with pytest.raises(RuntimeError, match="still running"):
        launch.spawn(1, dryrun.rank_body, (plan,), "cpu", 0.3)
    assert not mp.active_children()


def test_one_rank_runs_and_counts():
    plan = {"ntt": {"kind": "ntt", "mesh": (1, 1), "q": PRIMES_27BIT[0],
                    "variant": "4step",
                    "x": dryrun.ntt_input(64, PRIMES_27BIT[0], 2, 0)}}
    [out] = launch.spawn(1, dryrun.rank_body, (plan,), "cpu", 120)
    want = dryrun.reference(plan["ntt"])["y"]
    assert (out["ntt"]["out"]["y"] == want).all()
    assert out["ntt"]["comm"] == {"all_to_all": [2, 2 * 2 * 64 * 4]}


def test_backend_follows_the_device():
    assert comm.backend_for("cpu") == "gloo"
    with pytest.raises(ValueError):
        comm.backend_for("tpu")
    if torch.cuda.is_available():
        assert comm.backend_for("cuda") == "nccl"
    else:
        with pytest.raises(RuntimeError):
            comm.backend_for("cuda")
