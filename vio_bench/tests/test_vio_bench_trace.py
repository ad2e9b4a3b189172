"""The trace reader attributes a synthetic replay trace to the eager step's
stages and refuses a trace without device operations."""

from __future__ import annotations

import pytest

from vio_bench.trace import NoDeviceOperations, TraceRecord, breakdown, union_us

STAGES = ("fe.pyramid", "fe.lk", "filt.consume")
STEP = "pipeline_step"


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def _launch(name, ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1, "pid": 1, "tid": 1,
            "args": {"correlation": corr}}


def _op(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7, "args": {"correlation": corr}}


def _trace(replays: int = 2, drop: int | None = None):
    ev = [_span("vb.window", 0, 1000), _span(STEP, 2000, 1000), _span("fe.pyramid", 2000, 200),
          _span("fe.lk", 2200, 200), _span("filt.consume", 2400, 600)]
    ev += [_launch("cudaLaunchKernel", 2010, 1), _op("void pyr<float>(float*)", 2050, 4, 1),
           _launch("cudaLaunchKernel", 2210, 2), _op("void lk_track_kernel(int)", 2260, 3, 2),
           _launch("cudaMemcpyAsync", 2410, 3), _op("Memcpy DtoD (Device -> Device)", 2500, 2, 3, "gpu_memcpy"),
           _launch("cudaLaunchKernel", 2420, 4), _op("void consume(float*)", 2520, 20, 4)]
    for r in range(replays):
        c, t = 100 + r, 100 + 300 * r
        ev.append(_span("vb.frame", t - 5, 200))
        ev.append(_launch("cudaGraphLaunch", t, c))
        ops = [("void pyr<float>(float*)", 5, "kernel"), ("void lk_track_kernel(int)", 3, "kernel"),
               ("memcpy32_post", 2, "gpu_memcpy"), ("void consume(float*)", 20, "kernel"),
               ("memcpy32_post", 1, "gpu_memcpy")]
        for i, (name, dur, cat) in enumerate(ops):
            if r == 1 and drop == i:
                continue
            ev.append(_op(name, t + 10 + 30 * i, dur, c, cat))
    return ev


def test_replays_mapped_onto_the_eager_step():
    res = breakdown(_trace(), STAGES, STEP)
    cap = res["captured"]
    assert cap["frames"] == 2
    assert cap["stages"]["fe.pyramid"]["ms"] == pytest.approx(0.005)
    assert cap["stages"]["fe.lk"]["ms"] == pytest.approx(0.003)
    assert cap["stages"]["filt.consume"]["ms"] == pytest.approx(0.022)  # the copy folds onto the eager copy
    assert cap["stages"]["graph tail"]["ms"] == pytest.approx(0.001)
    assert res["eager"]["frames"] == 1


def test_a_replay_short_of_a_record_is_mapped_against_a_full_one():
    res = breakdown(_trace(drop=1), STAGES, STEP)
    assert "2 of 2 replays mapped" in res["note"] and "1 short" in res["note"]
    assert res["captured"]["stages"]["fe.lk"]["ms"] == pytest.approx(0.0015)


def test_record_reads_the_window():
    rec = TraceRecord(_trace(), STAGES, STEP, 2, {})
    assert len(rec.ops) == 10  # the eager step lies outside the window
    assert rec.window_s == pytest.approx(1e-3)
    assert rec.busy_s == pytest.approx(62e-6)
    assert rec.stage_ms("fe.") == pytest.approx(0.008)
    assert rec.kernel_ms("lk_track_kernel") == pytest.approx(0.006)
    assert [round(h) for h, _ in rec.frame_spans()] == [200, 200]
    assert rec.top_ops(1)[0][0] == "void consume(float*)"
    assert sum(v for _, v in rec.idle_gaps()) == pytest.approx(1e-3 - 62e-6)


def test_host_metrics_read_the_untraced_calls():
    from vio_bench.registry import Registry

    rec = TraceRecord(_trace(), STAGES, STEP, 2, {"host_calls": [(13.0, 12.0), (14.5, 12.5), (16.0, 14.0)]})
    assert Registry.reader("host_ms.stream")(rec) == pytest.approx(2.0)
    assert Registry.reader("device_idle_share.stream")(rec) == pytest.approx(100 * (1 - 38.5 / 43.5))
    assert Registry.reader("host_ms.stream")(TraceRecord(_trace(), STAGES, STEP, 2, {})) is None


def test_a_trace_without_device_operations_is_refused():
    host_only = [e for e in _trace() if e["cat"] not in ("kernel", "gpu_memcpy", "gpu_memset")]
    with pytest.raises(NoDeviceOperations):
        breakdown(host_only, STAGES, STEP)
    with pytest.raises(NoDeviceOperations):
        TraceRecord(host_only, STAGES, STEP, 2, {})


def test_union():
    assert union_us([(0, 2), (1, 3), (5, 6)]) == 4
