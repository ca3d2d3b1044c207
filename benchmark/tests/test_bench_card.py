"""On a card only: the one command end to end, a short window of each
cell's smallest, and the result line's form."""

import json
import subprocess
import sys

import pytest

from benchmark.catalog import HERE, REPO, Catalog


@pytest.mark.card
@pytest.mark.parametrize("traced", [0, 1])
def test_a_short_run_is_correct_and_well_formed(card, traced):
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          "n4096.sym.b16", "--seed", str(2 ** 31 + 3),
                          "--seconds", "2", "--trace", str(traced)],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=360, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["count"] == 1
    want = Catalog().per_layer if traced else Catalog().end_to_end
    assert set(result["metrics"]) <= {m["name"] for m in want(
        "n4096.sym.b16")}
    if traced:
        assert result["device"]["busy_s"] > 0
    else:
        assert {"enc_per_s", "call_ms_p95", "peak_mib", "setup_s"} == \
            set(result["metrics"])
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
