"""Reading a profiler trace: device time by range through the launch's
correlation id, busy time as a union, idle gaps by the host's range."""
from __future__ import annotations

from perfbench import trace


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_summarize_attributes_by_correlation_and_unions_busy_time():
    ev = [
        _x("user_annotation", "pb.step", 0, 100),
        _x("user_annotation", "pb.spec", 1, 40),
        _x("user_annotation", "pb.cache_topk", 2, 5),
        _x("user_annotation", "pb.cloud", 50, 30),
        _x("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 1, correlation=2),
        _x("cuda_driver", "cuLaunchKernel", 55, 1, correlation=3),
        _x("kernel", "topk_scan_kernel", 10, 10, correlation=1),
        _x("kernel", "ivf_range_kernel", 15, 10, correlation=2),  # overlaps
        _x("kernel", "gemm", 60, 20, correlation=3),
        # no launch record: the device projection of pb.cloud holds it
        _x("gpu_user_annotation", "pb.step", 9, 80),
        _x("gpu_user_annotation", "pb.cloud", 59, 30),
        _x("gpu_memcpy", "Memcpy DtoH", 85, 2, correlation=99),
    ]
    s = trace.summarize(ev, n_steps=1, window_s=1e-4)
    assert abs(s.busy_s - (15 + 20 + 2) * 1e-6) < 1e-12
    assert abs(s.range_s["pb.spec"] - 20e-6) < 1e-12
    assert abs(s.range_s["pb.cache_topk"] - 10e-6) < 1e-12
    assert abs(s.range_s["pb.cloud"] - 22e-6) < 1e-12
    assert s.range_ops == {"pb.step": 4, "pb.spec": 2, "pb.cache_topk": 1,
                           "pb.cloud": 2}
    assert s.device_ops[0][0] == "gemm"
    gaps = dict(s.idle_gaps)
    # 0-10: the host in pb.cache_topk; 25-60, 80-85, 87-100: in pb.step
    assert set(gaps) == {"pb.cache_topk", "pb.step"}
    assert abs(gaps["pb.cache_topk"] - 10e-6) < 1e-12
    assert abs(gaps["pb.step"] - 53e-6) < 1e-12
