"""The program's span recorder stays off through a run without a trace:
the untraced run measures the program as its users run it."""

import pytest

from benchmark import harness, traffic
from benchmark.tests import copies


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A copy of the benchmark whose traffic runs B = 4 on the CPU."""
    return copies.copy(tmp_path_factory.mktemp("bench"), batch=4)


def test_an_untraced_run_never_turns_the_recorder_on(small, monkeypatch):
    from seal_embedded_tpu_torch.utils import timing
    monkeypatch.setattr(harness, "WARMUP_CALLS", 1)
    monkeypatch.setattr(traffic, "VALUE_BATCHES", 2)
    monkeypatch.setattr(traffic, "CHECK_MESSAGES", 2)
    turned = []
    monkeypatch.setattr(timing, "record_spans", turned.append)
    timing.take_spans()
    result = harness.run(small, "n4096.sym.b16", 2 ** 31 + 17, 0.01, False,
                         "cpu")
    assert result["correct"], result["checks"]
    assert turned == [] and timing.take_spans() == []
