"""A run with the timed path broken underneath reads ``correct`` false,
for each fault the cells can have; the same run unbroken reads true."""

import pytest

from benchmarks import manifest, run


# The harness's four-card path, run by a cell that names the sharded mix.
SHARDED = {"name": "cornell_mixed.sharded_4k", "config": "cornell_mixed",
           "traffic": "sharded_4k", "chips": 4, "why": "the (2, 2) mesh"}


def _run(cell, tiny, factory, seconds=0.05):
    config = manifest.config(cell["config"])
    traffic = dict(manifest.traffic(cell["traffic"]), **tiny)
    line, err, found = run.run_cell(cell, config, traffic, 2**33 + 12345, seconds,
                                    False, device="cpu", factory=factory)
    assert not found
    assert err[-2].startswith("check mismatch_share") and err[-1].startswith("check median_gap")
    assert list(line)[-1] == "checked"
    return line


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "altered"])
def test_one_card_fault_reads_incorrect(fault, tiny):
    factory = ("benchmarks.session:build" if fault is None
               else f"benchmarks.tests.faults:{fault}")
    line = _run(manifest.cell("cornell_mixed.final"), tiny, factory)
    assert line["correct"] is (fault is None), line["checked"]


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_sharded_fault_reads_incorrect(fault, tiny):
    tiny = dict(tiny, width=8, height=8, max_depth=2)
    factory = ("benchmarks.session:build" if fault is None
               else f"benchmarks.tests.faults:{fault}")
    line = _run(SHARDED, tiny, factory, seconds=0.01)
    assert line["device"]["count"] == 4
    assert line["correct"] is (fault is None), line["checked"]
