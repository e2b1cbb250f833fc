"""The frozen yardstick: the trace reader on a hand-made trace and B1's
work count by hand."""

import pytest

from portbench.work import b1, trace


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_the_trace_reader_splits_device_time_by_span_and_names_the_gaps():
    events = [
        _x("user_annotation", "repro.allocate", 0, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 5, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=2),
        _x("cuda_runtime", "cudaStreamSynchronize", 160, 200),
        _x("kernel", "pb_tails", 200, 50, correlation=1),
        _x("kernel", "sort", 220, 50, correlation=2),
        _x("cpu_op", "aten::copy_", 300, 80),
        _x("kernel", "sort", 400, 10, correlation=3),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},
    ]
    got = trace.read(events)
    span = got["spans"]["repro.allocate"]
    assert span["calls"] == 1 and span["device_ops"] == 1
    assert span["host_ms"] == pytest.approx(0.1) and span["device_ms"] == pytest.approx(0.05)
    assert got["unspanned_ms"] == pytest.approx(0.06) and got["unspanned_ops"] == 2
    assert got["busy_s"] == pytest.approx(80e-6)      # 200..270 and 400..410
    assert got["ops"] == 3 and got["syncs"] == 1
    assert got["by_kernel"] == pytest.approx({"pb_tails": 0.05, "sort": 0.06})
    assert got["idle_gaps"] == [("aten::copy_", pytest.approx(130e-6))]
    assert trace.top_ops(got) == [("sort", pytest.approx(6e-5)),
                                  ("pb_tails", pytest.approx(5e-5))]


def test_b1_work_counts_the_dp_by_hand():
    # 2 rows of 3 workers, thresholds (1, 2, 4): the third prefix can never
    # reach 4, the first two add one tail term each
    moved, ops = b1.launch_work(2, 3, [1, 2, 4], 1)
    assert moved == 2 * 2 * 3 * 4 + 1 * 3 * 4
    assert ops == 2 * (3 * 4 + 2 * 3) + 2 * (1 + 1)
