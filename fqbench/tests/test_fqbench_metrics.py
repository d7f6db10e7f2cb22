"""The per-layer metrics' arithmetic on a recorded DebugInfo and a small
Chrome trace of one job, and the end-to-end arithmetic on recorded
jobs."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from fqbench import harness, tracing  # noqa: E402

PEAKS = {"hbm_bytes_per_s": 1e9, "int32_ops_per_s": 1e9}
CGRID = torch.tensor([[10, 10, 10, 10], [10, 5, 5, 10], [10, 10, 5, 5]],
                     dtype=torch.int32)


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def runtime(name, ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": 5, "pid": 1, "tid": tid, "args": {"correlation": corr}}


def device(cat, name, ts, dur, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


def events():
    return [
        span("fqbench.compress", 1000, 10000),
        span("fqbench.decompress", 12000, 10000),
        span("fqk.frozen_encode_lanes#0", 2000, 100),
        span("fqk.frozen_decode#1", 13000, 100),
        runtime("cudaLaunchKernel", 2050, 5),
        runtime("cudaLaunchKernel", 3000, 7),          # PyTorch's fill
        runtime("cudaLaunchKernelExC", 13050, 9),
        device("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1500, 200),
        device("kernel", "void chunk_sf<0>(int*)", 2200, 300, 5),
        device("kernel", "void at::native::fill(float*)", 3000, 100, 7),
        device("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 12500, 400),
        device("kernel", "void (anonymous namespace)::decode_one<1, 8, "
               "(anonymous namespace)::X>(int*)", 13200, 2000, 9),
    ]


def calls():
    enc = tracing.Call("frozen_encode_lanes", 0, tracing.describe((
        torch.zeros((10, 4), dtype=torch.uint8), CGRID,
        torch.zeros(64, dtype=torch.int32), None)), {}, tracing.describe((
            torch.zeros((10, 4), dtype=torch.int16),
            torch.zeros((10, 4), dtype=torch.uint8),
            torch.zeros(4, dtype=torch.int32))))
    dec = tracing.Call("frozen_decode", 1, tracing.describe((
        torch.zeros(4, dtype=torch.int32),
        torch.zeros(1024, dtype=torch.int16), CGRID, 10,
        torch.zeros((16, 5), dtype=torch.int16), None)), {},
        tracing.describe(torch.zeros((10, 4), dtype=torch.uint8)))
    return [enc, dec]


DELTA = {"frozen_encode_lanes": 1, "frozen_decode": 1, "quant_pack": 0}


def test_per_layer_arithmetic():
    traced = tracing.reduce_trace(events(), calls(), DELTA, PEAKS)
    job = harness.Job(input_bytes=2_000_000, restored_bytes=2_000_000)
    job.dbg = {"compress": {"parse_s": 1.0, "dispatch_s": 0.5,
                            "encode_s": 0.5, "train_s": 2.0, "sz_seq": 250,
                            "raw_seq": 1000, "sz_qual": 300,
                            "raw_qual": 1000},
               "decompress": {"decode_s": 1.5}}
    cell = harness.load_cell("se_default.roundtrip")
    got, breakdown = tracing.per_layer(cell, job, traced)
    want = {
        "driver.encode_ms_per_MB": 1000.0,
        "driver.decode_ms_per_MB": 750.0,
        "frozen.train_ms_per_MB": 1000.0,
        "blockcodec.seq_bits_per_base": 2.0,
        "blockcodec.qual_bits_per_symbol": 2.4,
        "engine.copy_ms_per_MB.compress": 0.1,
        "engine.copy_ms_per_MB.decompress": 0.2,
        "kernels.device_ms_per_MB.compress": 0.2,
        "kernels.device_ms_per_MB.decompress": 1.0,
        # frozen_encode_lanes: 30 ops x 100 symbols at 1e9/s = 3 us (its
        # 480 bytes take 0.48 us) over its 300 us; frozen_decode: 2,500
        # ops = 2.5 us (1,288 bytes 1.288 us) over 2,000 us
        "kernels.roofline_share.compress": 1.0,
        "kernels.roofline_share.decompress": 0.125,
        "device.idle_share.compress": 94.0,
        "device.idle_share.decompress": 76.0,
    }
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k]["value"] == pytest.approx(v), k
        assert got[k]["unit"] == next(m["unit"] for m in cell.per_layer
                                      if m["name"] == k)
    assert traced.busy_s == pytest.approx(0.003)
    assert traced.window_s == pytest.approx(0.021)
    names = [n for n, _ in breakdown["device_ops"]]
    assert names[0] == "decode_one<1, 8, X>" and "chunk_sf<0>" in names
    gaps = dict(breakdown["idle_gaps"])
    assert gaps["decompress call, after decode_one<1, 8, X> (to the call's "
                "end)"] == pytest.approx(0.0068)
    assert len(breakdown["idle_gaps"]) <= 10


def test_a_reader_with_nothing_to_read_is_left_out():
    traced = tracing.reduce_trace(events(), calls(), DELTA, PEAKS)
    job = harness.Job(input_bytes=2_000_000, restored_bytes=2_000_000)
    job.dbg = {"compress": {"encode_s": 1.0, "sz_seq": 1, "raw_seq": 4,
                            "sz_qual": 1, "raw_qual": 4},
               "decompress": {"decode_s": 1.0}}
    cell = harness.load_cell("se_q3.roundtrip")
    got, _ = tracing.per_layer(cell, job, traced)
    assert "frozen.train_ms_per_MB" not in got
    assert got["driver.encode_ms_per_MB"]["value"] == pytest.approx(500.0)


def test_a_launch_without_its_kernel_record_fails():
    evs = [e for e in events() if (e.get("args") or {}).get(
        "correlation") != 5 or e["cat"] != "kernel"]
    with pytest.raises(RuntimeError, match="no device record"):
        tracing.reduce_trace(evs, calls(), DELTA, PEAKS)


def test_fewer_launches_than_launches_counted_fails():
    with pytest.raises(RuntimeError, match="fewer than LAUNCHES"):
        tracing.reduce_trace(events(), calls(),
                             dict(DELTA, frozen_decode=2), PEAKS)


def test_busy_union():
    assert tracing.busy_ms([(0, 10), (5, 20), (30, 40)], 0, 35) == \
        pytest.approx(0.025)


def test_end_to_end_arithmetic():
    jobs = [harness.Job(index=1, compress_s=2.0, decompress_s=1.0,
                        input_bytes=10_000_000, archive_bytes=2_500_000,
                        restored_bytes=10_000_000),
            harness.Job(index=2, compress_s=3.0, decompress_s=1.0,
                        input_bytes=10_000_000, archive_bytes=2_500_000,
                        restored_bytes=10_000_000),
            harness.Job(index=3, error="RuntimeError: x")]
    got = harness.end_to_end(jobs, 12.5)
    assert got == {"setup_s": 12.5, "compress_MBps": 4.0,
                   "decompress_MBps": 10.0, "ratio": 4.0}
