"""The stage readers (metrics/ over the program's DebugInfo stage spans) on
a synthetic Context, and stages.py's reading of the program's fq.* ranges
in hand-made trace events: the card's idle time split by the innermost
open stage, and the share of a call under no stage."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from fqbench import harness, stages, tracing  # noqa: E402

NEW = ("frozen.hist_ms_per_MB", "frozen.qctx_ms_per_MB",
       "driver.serialize_ms_per_MB", "driver.probe_ms_per_MB",
       "blockcodec.host_ms_per_MB.compress",
       "blockcodec.wait_ms_per_MB.compress",
       "blockcodec.host_ms_per_MB.decompress",
       "blockcodec.wait_ms_per_MB.decompress", "driver.assemble_ms_per_MB",
       "driver.md5_ms_per_MB.decompress", "driver.unspanned_share.compress",
       "driver.unspanned_share.decompress")


def context(compress, decompress):
    """4 MB in, 2 MB restored; calls of 2 s and 1 s in the trace."""
    return tracing.Context(4.0, 2.0, {"compress": compress,
                                      "decompress": decompress},
                           {"compress": tracing.Phase("compress", 0, 2e6),
                            "decompress": tracing.Phase("decompress", 3e6,
                                                        4e6)})


def reader(name):
    return harness.load_cell("se_default.roundtrip").reader(name)


@pytest.mark.parametrize("name, want", [
    ("frozen.hist_ms_per_MB", 100.0),
    ("frozen.qctx_ms_per_MB", 200.0),
    ("driver.serialize_ms_per_MB", 25.0),
    ("driver.probe_ms_per_MB", 12.5),
    ("blockcodec.host_ms_per_MB.compress", 75.0),
    ("blockcodec.wait_ms_per_MB.compress", 5.0),
    ("blockcodec.host_ms_per_MB.decompress", 150.0),
    ("blockcodec.wait_ms_per_MB.decompress", 50.0),
    ("driver.assemble_ms_per_MB", 30.0),
    ("driver.md5_ms_per_MB.decompress", 20.0),
    ("driver.unspanned_share.compress", 5.0),
    ("driver.unspanned_share.decompress", 2.0),
])
def test_stage_reader(name, want):
    ctx = context(
        {"train.hist_s": 0.4, "train.qctx_s": 0.8, "serialize_s": 0.1,
         "probe_s": 0.05, "codec.dedup_s": 0.05, "codec.vocab_s": 0.1,
         "codec.ids_s": 0.1, "codec.plus_s": 0.01, "codec.small_s": 0.04,
         "codec.streams_s": 0.5, "codec.wait_s": 0.02, "spanned_s": 1.9},
        {"codec.host_s": 0.3, "codec.wait_s": 0.1, "assemble_s": 0.06,
         "md5_s": 0.04, "spanned_s": 0.98})
    assert reader(name)(ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_a_table_without_stage_spans_reads_nothing(name):
    """The parent's tables (the timers before spans) have none of the
    keys: each reader finds nothing and raises nothing."""
    ctx = context({"parse_s": 1.0, "dispatch_s": 0.5, "encode_s": 0.5,
                   "train_s": 2.0, "selfref_probe_s": 0.1},
                  {"decode_s": 1.0})
    assert reader(name)(ctx) is None


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def device(ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur,
            "pid": 0, "tid": 7}


def events():
    """compress [0, 1000): train [0, 600) around train.hist [100, 300),
    dispatch [700, 900); device busy [250, 350) and [750, 800); a range
    on another thread and one outside the call.  decompress [2000,
    2100): no stage, no device record."""
    return [span("fqbench.compress", 0, 1000),
            span("fqbench.decompress", 2000, 100),
            span("fq.train", 0, 600), span("fq.train.hist", 100, 200),
            span("fq.dispatch", 700, 200),
            span("fq.codec.ids", 0, 1000, tid=2),
            span("fq.read", 1500, 100),
            device(250, 100), device(750, 50, "gpu_memcpy")]


def test_idle_split_by_the_innermost_stage():
    got = stages.idle_by_stage(events())
    # idle [0, 250): train 100 + train.hist 150; [350, 750): train 250,
    # unspanned 100, dispatch 50; [800, 1000): dispatch 100, unspanned 100
    assert got["compress"] == pytest.approx({
        "train": 350e-6, "train.hist": 150e-6, "dispatch": 150e-6,
        "unspanned": 200e-6})
    assert got["decompress"] == pytest.approx({"unspanned": 100e-6})
    idle = {"compress": 850e-6, "decompress": 100e-6}
    for p, sums in got.items():
        assert sum(sums.values()) == pytest.approx(idle[p])
    top = stages.top_idle(got, 3)
    assert top[0] == ["compress call, in train", pytest.approx(350e-6)]
    assert len(top) == 3


def test_unspanned_share_of_each_call():
    got = stages.unspanned_share(events())
    assert got == pytest.approx({"compress": 20.0, "decompress": 100.0})
