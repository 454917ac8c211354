"""The trace reduction and the per-layer readers on made-up events and
records whose answers are known."""

import pytest

from benchmarks import manifest, timing, trace


class Ev:
    """A stand-in for the profiler's kineto event."""

    def __init__(self, name, start, dur, device=False, thread=1, annotation=False):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._t, self._a = device, thread, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def end_ns(self):
        return self._s + self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._a


def test_reduce_counts_busy_gaps_and_kernels():
    events = [
        Ev("bench.window", 0, 1000),
        Ev("bench.window", 0, 1000, device=True, annotation=True),
        Ev("aten::mul", 0, 300), Ev("cudaLaunchKernel", 120, 50),
        Ev("cudaStreamSynchronize", 450, 350),
        Ev("void closest_lean_tree_kernel<8>(float const*)", 200, 100, device=True),
        Ev("void at::native::add_kernel(int)", 250, 150, device=True),
        Ev("Memcpy DtoH", 700, 50, device=True),
        Ev("ncclDevKernel_AllReduce_Sum_f32", 900, 50, device=True),
    ]
    r = trace.reduce(events)
    assert r["window_s"] == pytest.approx(1e-6)
    # Device busy: [200, 400) + [700, 750) + [900, 950).
    assert r["busy_s"] == pytest.approx(300e-9)
    assert r["blocked_s"] == pytest.approx(350e-9)
    assert set(r["kernels"]) == {"void closest_lean_tree_kernel<8>(float const*)",
                                 "void at::native::add_kernel(int)",
                                 "ncclDevKernel_AllReduce_Sum_f32"}
    gaps = dict(r["idle_gaps"])
    assert gaps["aten::mul"] == pytest.approx(200e-9)          # [0, 200)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(300e-9)  # [400, 700)
    assert gaps["python"] == pytest.approx(200e-9)             # [750, 900), [950, 1000)
    rank = {"trace": r}
    assert trace.kernel_time(rank, "own") == (1, pytest.approx(100e-9))
    assert trace.kernel_time(rank, "collective") == (1, pytest.approx(50e-9))
    assert trace.other_kernel_time(rank) == (1, pytest.approx(150e-9))


def _record(world=1):
    kernels = {"void (anonymous namespace)::closest_lean_tree_kernel<8>(x)": [10, 0.02],
               "void (anonymous namespace)::occluded_split_kernel(x)": [10, 0.01],
               "void at::native::elementwise_kernel<x>": [4000, 0.5],
               "ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)": [2, 0.004]}
    rank = {"trace": {"window_s": 1.0, "busy_s": 0.75, "blocked_s": 0.4,
                      "kernels": kernels},
            "launches": {"dense.closest_lean_tree": 10, "dense.occluded": 10}}
    return dict(frames=2, world=world, rounds=10 * world, rays_traced=6_000_000 * world,
                lanes=1_000_000, triangles=1000, peaks=manifest.data("peaks.json"),
                ranks=[rank] * world)


def test_readers():
    rec = _record()

    def read(name):
        return manifest.metric_reader(name)(rec)
    assert read("device_idle_pct") == pytest.approx(25.0)
    assert read("intersect_ms_per_frame") == pytest.approx(15.0)
    assert read("eager_ms_per_frame") == pytest.approx(250.0)
    assert read("eager_launches_per_round") == pytest.approx(400.0)
    assert read("rounds_per_frame") == pytest.approx(5.0)
    assert read("lane_occupancy_pct") == pytest.approx(60.0)
    assert read("host_ms_per_round") == pytest.approx(60.0)
    assert read("allreduce_ms_per_frame") is None
    least = 10 * (32e6 + 36e3) + 10 * (29e6 + 36e3)
    assert read("intersect_roofline_pct") == pytest.approx(
        100 * least / 3.35e12 / 0.03)
    rec4 = _record(world=4)
    assert manifest.metric_reader("allreduce_ms_per_frame")(rec4) == pytest.approx(2.0)
    assert manifest.metric_reader("rounds_per_frame")(rec4) == pytest.approx(5.0)


def test_readers_find_nothing_to_read():
    rec = _record()
    rec["ranks"] = [dict(rec["ranks"][0], trace=dict(rec["ranks"][0]["trace"], kernels={}))]
    assert manifest.metric_reader("intersect_ms_per_frame")(rec) is None
    assert manifest.metric_reader("intersect_roofline_pct")(rec) is None


def test_ray_counts():
    class S:
        def __init__(self, r, s, i):
            self.rays_traced, self.shadow_rays, self.wavefront_iterations = r, s, i
    c = timing.ray_counts([S(10, 3, 2), S(20, 4, 3)])
    assert c == dict(rays_traced=30, shadow_rays=7, rays=37, rounds=5)
