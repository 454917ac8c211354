"""The span summary and its readers on made-up events and records whose
answers are known."""

import pytest

from benchmarks import manifest, spans, trace
from benchmarks.tests import test_bench_metrics

K_EAGER = "void at::native::vectorized_elementwise_kernel<4>(int)"
K_OWN = "void (anonymous namespace)::closest_lean_tree_kernel<8>(x)"
READERS = ("rng_ms_per_frame", "intersect_eager_ms_per_frame", "shade_ms_per_frame",
           "nee_ms_per_frame", "queue_ms_per_frame", "prepare_ms_per_frame",
           "issue_ms_per_round", "host_syncs_per_round")


class Ev(test_bench_metrics.Ev):
    """A profiler event with a correlation id."""

    def __init__(self, name, start, dur, corr=0, **kw):
        super().__init__(name, start, dur, **kw)
        self._c = corr

    def correlation_id(self):
        return self._c


def _plain():
    """A window of one round without spans: three kernels, a blocking
    copy, the loop test's synchronisation, the window's end."""
    return [
        Ev("bench.window", 0, 1000),
        Ev("bench.window", 0, 1000, device=True, annotation=True),
        Ev("aten::mul", 110, 20, corr=900),
        Ev("cudaLaunchKernel", 112, 5, corr=1),                  # in pt.rng
        Ev("cudaLaunchKernel", 210, 5, corr=2),                  # pt.intersect
        Ev("cudaLaunchKernel", 310, 5, corr=3),                  # pt.nee, in pt.shade
        Ev("cudaMemcpy", 400, 40, corr=4),                       # pt.shade: a wait
        Ev("cudaMemcpyAsync", 460, 5, corr=5),                   # not a wait alone
        Ev("cudaStreamSynchronize", 700, 100, corr=6),           # the loop test
        Ev("cudaLaunchKernel", 955, 5, corr=7),                  # in no span
        Ev("cudaStreamSynchronize", 30, 10, corr=8, thread=2),   # another thread
        Ev(K_EAGER, 120, 60, corr=1, device=True),
        Ev(K_OWN, 220, 50, corr=2, device=True),
        Ev(K_EAGER, 320, 30, corr=3, device=True),
        Ev("Memcpy HtoD (Pageable -> Device)", 420, 10, corr=4, device=True),
        Ev(K_EAGER, 600, 40, corr=99, device=True),              # no launch: pt.queue's
        Ev(K_EAGER, 960, 20, corr=7, device=True),
    ]


def _spanned():
    host = [Ev("pt.frame", 100, 850), Ev("pt.round", 105, 590),
            Ev("pt.rng", 108, 50), Ev("pt.intersect", 200, 50),
            Ev("pt.shade", 300, 200), Ev("pt.nee", 305, 30),
            Ev("pt.queue", 550, 140)]
    dev = [Ev("pt.queue", 590, 60, device=True, annotation=True),
           Ev("pt.round", 110, 540, device=True, annotation=True)]
    return _plain() + host + dev


def test_summary_attributes_work_to_the_innermost_span():
    s = spans.summary(_spanned())
    assert set(s) == {"pt.frame", "pt.round", "pt.rng", "pt.intersect", "pt.shade",
                      "pt.nee", "pt.queue", spans.NONE}
    assert s["pt.rng"]["kernels"] == {K_EAGER: [1, pytest.approx(60e-9)]}
    assert s["pt.intersect"]["kernels"] == {K_OWN: [1, pytest.approx(50e-9)]}
    # The launch lies in pt.nee inside pt.shade: the innermost one owns it.
    assert s["pt.nee"]["kernels"] == {K_EAGER: [1, pytest.approx(30e-9)]}
    assert s["pt.shade"]["kernels"] == {}
    # No launch in the trace: the innermost device annotation around it.
    assert s["pt.queue"]["kernels"] == {K_EAGER: [1, pytest.approx(40e-9)]}
    assert s[spans.NONE]["kernels"] == {K_EAGER: [1, pytest.approx(20e-9)]}
    assert s["pt.round"]["count"] == 1 and s["pt.frame"]["host_s"] == pytest.approx(850e-9)
    # Waits: the blocking copy in pt.shade, the loop test in pt.frame outside
    # the round; the asynchronous copy and the other thread's are none.
    assert s["pt.shade"]["waits"] == [1, pytest.approx(40e-9)]
    assert s["pt.frame"]["waits"] == [1, pytest.approx(100e-9)]
    assert sum(b["waits"][0] for b in s.values()) == 2
    assert s["pt.round"]["issue_s"] == pytest.approx((590 - 40) * 1e-9)
    assert s["pt.frame"]["issue_s"] == pytest.approx((850 - 140) * 1e-9)
    # Idle gaps by the innermost span at their midpoints: [0, 120) at 60 and
    # [980, 1000) none; [180, 220) pt.intersect; [270, 320) at 295, before
    # pt.shade, and [430, 600) at 515, between pt.shade and pt.queue,
    # pt.round; [350, 420) pt.shade; [640, 960) pt.frame.
    idle = {n: b["idle_s"] for n, b in s.items() if b["idle_s"]}
    assert idle == {spans.NONE: pytest.approx(140e-9),
                    "pt.intersect": pytest.approx(40e-9),
                    "pt.round": pytest.approx(220e-9),
                    "pt.shade": pytest.approx(70e-9),
                    "pt.frame": pytest.approx(320e-9)}
    # Every kernel once, every idle nanosecond once.
    r = trace.reduce(_spanned())
    assert sum(v[1] for b in s.values() for v in b["kernels"].values()) == pytest.approx(
        sum(v[1] for v in r["kernels"].values()))
    assert sum(b["idle_s"] for b in s.values()) == pytest.approx(r["window_s"] - r["busy_s"])


def test_reduce_is_unchanged_by_the_spans():
    plain, spanned = trace.reduce(_plain()), trace.reduce(_spanned())
    for key in ("window_s", "busy_s", "blocked_s", "kernels", "device_ops"):
        assert spanned[key] == plain[key], key
    assert not any(k.startswith("pt.") for k in spanned["kernels"])
    # The idle gaps are the same; only some that "python" held get a span's
    # name.
    assert sum(v for _, v in spanned["idle_gaps"]) == pytest.approx(
        sum(v for _, v in plain["idle_gaps"]))
    named = {n: v for n, v in spanned["idle_gaps"] if n.startswith("pt.")}
    assert named and dict(plain["idle_gaps"])["python"] == pytest.approx(
        dict(spanned["idle_gaps"])["python"] + sum(named.values()))
    assert {n: v for n, v in plain["idle_gaps"] if n != "python"} == {
        n: v for n, v in spanned["idle_gaps"] if n != "python" and n not in named}


def _summary(f=1.0, frames=2, rounds=10):
    """One rank's summary, its times scaled by ``f``: 30 ms of RNG, 6 of
    eager intersection beside 20 of the own kernels, 12 of shading, 4 of
    NEE, 8 of the queue; 2 ms in pt.prepare; 50 ms of rounds, 10 of them
    waiting; 25 waits."""
    def bucket(count=0, host=0.0, issue=0.0, kernels=None, waits=0):
        return dict(count=count, host_s=f * host, issue_s=f * issue,
                    kernels={k: [n, f * t] for k, (n, t) in (kernels or {}).items()},
                    waits=[waits, 0.001 * waits], idle_s=0.0)
    return {
        "pt.frame": bucket(frames, 0.2, 0.19, {K_EAGER: [2, 0.003]}, waits=1),
        "pt.prepare": bucket(frames, 0.002, 0.002),
        "pt.round": bucket(rounds, 0.05, 0.04, waits=rounds),
        "pt.rng": bucket(30, 0.01, 0.01, {K_EAGER: [300, 0.03]}),
        "pt.intersect": bucket(20, 0.01, 0.01, {K_EAGER: [40, 0.006], K_OWN: [20, 0.02]}),
        "pt.shade": bucket(10, 0.01, 0.01, {K_EAGER: [200, 0.012]}, waits=10),
        "pt.nee": bucket(10, 0.01, 0.01, {K_EAGER: [60, 0.004]}),
        "pt.queue": bucket(10, 0.01, 0.01, {K_EAGER: [100, 0.008]}),
        spans.NONE: bucket(kernels={K_EAGER: [1, 0.0001]}, waits=4),
    }


def _record(scales=(1.0,), frames=2, rounds=10):
    """A record of one rank a scale; the sharded step counts the world's
    rounds."""
    return dict(frames=frames, world=len(scales), rounds=rounds * len(scales),
                ranks=[{"trace": {"spans": _summary(f, frames, rounds)}} for f in scales])


@pytest.mark.parametrize("scales", [(1.0,), (0.5, 1.5, 0.75, 1.25)])
def test_readers(scales):
    rec = _record(scales)
    got = {n: manifest.metric_reader(n)(rec) for n in READERS}
    assert got == dict(rng_ms_per_frame=pytest.approx(15.0),
                       intersect_eager_ms_per_frame=pytest.approx(3.0),
                       shade_ms_per_frame=pytest.approx(6.0),
                       nee_ms_per_frame=pytest.approx(2.0),
                       queue_ms_per_frame=pytest.approx(4.0),
                       prepare_ms_per_frame=pytest.approx(1.0),
                       issue_ms_per_round=pytest.approx(4.0),
                       host_syncs_per_round=pytest.approx(2.5))


def test_readers_without_spans():
    rec = _record()
    for r in ({"trace": {}}, {"trace": {"spans": {spans.NONE: rec["ranks"][0]["trace"]
                                                    ["spans"][spans.NONE]}}}):
        rec["ranks"] = [r]
        assert all(manifest.metric_reader(n)(rec) is None for n in READERS)
