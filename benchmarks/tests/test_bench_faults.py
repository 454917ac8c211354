"""A run with the timed path broken underneath reads ``correct`` false,
for each fault the cells can have; the same run unbroken reads true."""

import pytest

from benchmarks import manifest, run
from benchmarks.tests import whitted_cases


# A Whitted configuration, run as a cell of its own, and its four-card twin.
WHITTED = {"name": "alpha_shadow.small", "config": "alpha_shadow", "traffic": "small",
           "chips": 1, "why": "the Whitted renderer and its reference"}
WHITTED_SHARDED = {"name": "alpha_shadow.sharded", "config": "alpha_shadow",
                   "traffic": "sharded", "chips": 4, "why": "the (2, 2) mesh, Whitted"}
# The harness's four-card path, run by a cell that names the sharded mix.
SHARDED = {"name": "cornell_mixed.sharded_4k", "config": "cornell_mixed",
           "traffic": "sharded_4k", "chips": 4, "why": "the (2, 2) mesh"}


def _factory(fault):
    return "benchmarks.session:build" if fault is None else f"benchmarks.tests.faults:{fault}"


def _run(cell, traffic, factory, seconds=0.05, config=None):
    config = manifest.config(cell["config"]) if config is None else config
    line, err, found = run.run_cell(cell, config, traffic, 2**33 + 12345, seconds,
                                    False, device="cpu", factory=factory)
    assert not found
    assert err[-2].startswith("check mismatch_share") and err[-1].startswith("check median_gap")
    assert list(line)[-1] == "checked"
    return line


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "altered"])
def test_one_card_fault_reads_incorrect(fault, tiny):
    cell = manifest.cell("cornell_mixed.final")
    traffic = dict(manifest.traffic(cell["traffic"]), **tiny)
    line = _run(cell, traffic, _factory(fault))
    assert line["correct"] is (fault is None), line["checked"]


@pytest.mark.parametrize("renderer", ["path", "whitted"])
@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_sharded_fault_reads_incorrect(fault, renderer, tiny, monkeypatch):
    tiny = dict(tiny, width=8, height=8, max_depth=2)
    traffic = dict(manifest.traffic("sharded_4k"), **tiny)
    if renderer == "path":
        line = _run(SHARDED, traffic, _factory(fault), seconds=0.01)
    else:
        monkeypatch.setattr(manifest, "check", whitted_cases.own_check)
        line = _run(WHITTED_SHARDED, traffic, _factory(fault), seconds=0.01,
                    config=whitted_cases.alpha_shadow())
    assert line["device"]["count"] == 4
    assert line["correct"] is (fault is None), line["checked"]


WHITTED_TRAFFIC = dict(width=16, height=16, spp=2, max_depth=8, scheduler="pixelq",
                       samples_per_item=1, lanes=4096)


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch", "altered"])
def test_whitted_fault_reads_incorrect(fault, monkeypatch):
    """Under the limits that a Whitted cell's own check file would set
    (``whitted_cases.CHECK``); half of the samples left out moves only the
    pixels that an edge crosses, which the default limits miss."""
    monkeypatch.setattr(manifest, "check", whitted_cases.own_check)
    line = _run(WHITTED, WHITTED_TRAFFIC, _factory(fault), config=whitted_cases.alpha_shadow())
    assert line["correct"] is (fault is None), line["checked"]


def test_a_whitted_cell_needs_a_check_of_its_own():
    with pytest.raises(SystemExit, match=r"checks/alpha_shadow\.small\.json of its own"):
        run.run_cell(WHITTED, whitted_cases.alpha_shadow(), WHITTED_TRAFFIC, 1, 0.01, False,
                     device="cpu")
