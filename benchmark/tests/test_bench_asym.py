"""The public-key cell: its configuration, traffic and cell found by name,
a configuration's mode held to its cells' traffic, the redo counter's
metric, and a small asym run whose every row is drawn again."""

import pytest

from benchmark import harness, traffic
from benchmark.catalog import Catalog
from benchmark.reference.params import from_config
from benchmark.tests import copies

CELL = "n16384.asym.b512"


def test_the_catalog_finds_the_public_key_config_traffic_and_cell():
    c = Catalog()
    cell = c.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "seal-pk-n16384-L13", "asym.b512", 1)
    cfg = c.config(cell["config"])
    assert cfg["name"] == "seal-pk-n16384-L13" and cfg["mode"] == "asym"
    same = c.config("seal-n16384-L13")
    for key in ("degree", "moduli", "ntt_roots", "scale", "errors",
                "encode_precision", "secret_key", "seed_bytes"):
        assert cfg[key] == same[key], key
    assert from_config(cfg).nprimes == 13
    mix = c.traffic(cell["traffic"])
    assert traffic.validate(mix) == {"encrypt_type": "asym", "batch": 512,
                                     "values": {"low": -1.0, "high": 1.0}}
    names = [m["name"] for m in c.per_layer(CELL)]
    assert names == ["host_ms.batch", "limb_wait_ms", "registry_evictions",
                     "alloc_retries", "torch_ops_ms", "keccak_roofline",
                     "ntt_roofline", "idle_share", "ternary_redo_rows"]
    assert "ternary_redo_rows" in c.metric_files()


def test_every_cell_of_a_mode_sends_traffic_of_that_mode():
    """A configuration that states a mode (sym or asym) is run only under
    traffic of that encrypt_type."""
    c = Catalog()
    stated = 0
    for name in c.cells():
        cell = c.cell(name)
        mode = c.config(cell["config"]).get("mode")
        if mode is not None:
            stated += 1
            assert c.traffic(cell["traffic"])["encrypt_type"] == mode, name
    assert stated >= 1


class _Counts:
    def __init__(self, counts):
        self.redo_counts = lambda: dict(counts)


@pytest.mark.parametrize("counts,want", [
    ({"messages": 500_000, "rows": 13}, 26.0),
    ({"messages": 4_096, "rows": 0}, 0.0),
    ({"messages": 0, "rows": 0}, None),
])
def test_ternary_redo_rows_reads_the_program_counter(monkeypatch, counts,
                                                     want):
    """Rows per million asym messages from the program's counter of a
    faked run; None before any asym message."""
    from seal_embedded_tpu_torch.ckks import asym
    monkeypatch.setattr(asym, "redo_counts", _Counts(counts).redo_counts)
    assert Catalog().reader("ternary_redo_rows").read(None) == want


def test_ternary_redo_rows_is_silent_without_the_counter(monkeypatch):
    """A program that keeps no such counter (the parent of this cell)
    gives nothing, and nothing raises."""
    from seal_embedded_tpu_torch.ckks import asym
    monkeypatch.delattr(asym, "redo_counts")
    assert Catalog().reader("ternary_redo_rows").read(None) is None


def test_an_asym_run_whose_rows_all_fall_short_is_correct(tmp_path,
                                                          monkeypatch):
    """On the CPU, n = 4096 and B = 4, with one refill a ternary block:
    nearly every row is encrypted again, and the sampled rows still equal
    the reference; the metric reads the rows counted."""
    from seal_embedded_tpu_torch.ckks import asym
    from seal_embedded_tpu_torch.ckks import stream as st
    from seal_embedded_tpu_torch.ops import sampling
    monkeypatch.setattr(sampling, "TERNARY_QUEUE_CAP", 1)
    monkeypatch.setattr(harness, "WARMUP_CALLS", 1)
    monkeypatch.setattr(traffic, "VALUE_BATCHES", 2)
    monkeypatch.setattr(traffic, "CHECK_MESSAGES", 2)
    st._asym_stream.cache_clear()
    catalog = copies.copy(tmp_path, batch=4)
    before = asym.redo_counts()
    try:
        result = harness.run(catalog, copies.ASYM_CELL["name"],
                             2 ** 31 + 23, 0.01, False, "cpu")
    finally:
        st._asym_stream.cache_clear()
    after = asym.redo_counts()
    assert result["correct"], result["checks"]
    assert result["checks"]["pk_mismatches"]["value"] == 0
    assert after["messages"] - before["messages"] == result["attempted"] + 4
    assert after["rows"] - before["rows"] > result["attempted"] // 2
