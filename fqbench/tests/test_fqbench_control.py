"""What decides ``correct``, shown to fail: the control (the program's own
lossy quality path, -l, which breaks the lossless guarantee the
configurations state) and each fault a compress-then-verify job can
have, planted under the harness in a tiny CPU run (in the window, or in
the second compress that holds the archive to being repeatable), all
come out not correct; the sound run comes out correct.  The same run on the card at
the cells' size is test_fqbench_gpu.py."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from fqbench import harness  # noqa: E402
from fastqueeze_tpu_torch.pipeline import driver  # noqa: E402

CELLS = ("se_default.roundtrip", "se_q3.roundtrip")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tiny_cell):
    r = harness.run_cell(tiny_cell(name), 2**31 + 5, 0.5, False, "cpu")
    assert r["correct"] and r["failed"] == 0
    assert r["checks"] == {"bytes_wrong": {"value": 0, "limit": 0},
                           "jobs_failed": {"value": 0, "limit": 0},
                           "archives_unlike": {"value": 0, "limit": 0}}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_lossy_is_not_correct(name, tiny_cell):
    r = harness.run_cell(tiny_cell(name), 2**31 + 5, 0.5, False, "cpu",
                         control="lossy")
    assert not r["correct"]
    assert r["checks"]["bytes_wrong"]["value"] > 0


def _decompress_then(edit):
    """driver.decompress, its bytes edited on their way to the output."""
    real = driver.decompress

    def fake(arc, prefix, **kw):
        tmp = prefix + ".plain"
        real(arc, tmp, **kw)
        with open(tmp + ".fastq", "rb") as fh:
            data = fh.read()
        os.remove(tmp + ".fastq")
        with open(prefix + ".fastq", "wb") as fh:
            fh.write(edit(data))
        return [prefix + ".fastq"]
    return fake


def _flip(data: bytes) -> bytes:
    i = len(data) // 2
    return data[:i] + bytes([data[i] ^ 1]) + data[i + 1:]


def _compress_then(edit):
    """driver.compress_se, its archive or its input edited."""
    real = driver.compress_se

    def fake(params, in_path, out_path, **kw):
        return edit(real, params, in_path, out_path, **kw)
    return fake


def _archive_byte_altered(real, params, in_path, out_path, **kw):
    out = real(params, in_path, out_path, **kw)
    with open(out_path, "r+b") as fh:
        fh.seek(os.path.getsize(out_path) // 2)
        b = fh.read(1)
        fh.seek(-1, 1)
        fh.write(bytes([b[0] ^ 0x55]))
    return out


def _half_the_reads(real, params, in_path, out_path, **kw):
    with open(in_path, "rb") as fh:
        lines = fh.read().split(b"\n")
    keep = (len(lines) - 1) // 8 * 4
    half = in_path + ".half"
    with open(half, "wb") as fh:
        fh.write(b"\n".join(lines[:keep]) + b"\n")
    try:
        return real(params, half, out_path, **kw)
    finally:
        os.remove(half)


def _altered_where_produced(block):
    """assemble_block's output with one quality byte changed, as a
    decoder that got one symbol wrong would produce it."""
    from fastqueeze_tpu_torch.io.fastq import assemble_block
    raw = assemble_block(block)
    return _flip(raw)


FAULTS = {
    # a step that returns its state unchanged: nothing restored
    "nothing_restored": ("decompress", _decompress_then(lambda d: b"")),
    # half of the batch left out, on either side
    "half_restored": ("decompress", _decompress_then(
        lambda d: d[:len(d) // 2])),
    "half_compressed": ("compress_se", _compress_then(_half_the_reads)),
    # an answer altered where it is produced
    "restored_byte_altered": ("decompress", _decompress_then(_flip)),
    "decoded_byte_altered": ("assemble_block", _altered_where_produced),
    "archive_byte_altered": ("compress_se",
                             _compress_then(_archive_byte_altered)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, tiny_cell, monkeypatch):
    cell = tiny_cell(name)
    # the set-up job runs sound; the fault is planted under the window
    real_job = harness.run_job

    def run_job(cell_, work, inp, k, device, control=None, span=None):
        if k == 0:
            return real_job(cell_, work, inp, k, device, control, span)
        with monkeypatch.context() as m:
            m.setattr(driver, FAULTS[fault][0], FAULTS[fault][1])
            return real_job(cell_, work, inp, k, device, control, span)
    monkeypatch.setattr(harness, "run_job", run_job)
    r = harness.run_cell(cell, 2**31 + 9, 0.5, False, "cpu")
    assert not r["correct"], r["checks"]
    assert (r["checks"]["bytes_wrong"]["value"] > 0
            or r["checks"]["jobs_failed"]["value"] > 0)


@pytest.mark.parametrize("name", CELLS)
def test_an_archive_that_is_not_repeated_is_not_correct(name, tiny_cell,
                                                        monkeypatch):
    """The same input and flags give another archive (a byte of the
    second compress's archive altered): the round trips are sound, the
    guarantee is not."""
    real = harness.recompress_unlike

    def recompress_unlike(*args, **kw):
        with monkeypatch.context() as m:
            m.setattr(driver, "compress_se",
                      _compress_then(_archive_byte_altered))
            return real(*args, **kw)
    monkeypatch.setattr(harness, "recompress_unlike", recompress_unlike)
    r = harness.run_cell(tiny_cell(name), 2**31 + 13, 0.5, False, "cpu")
    assert not r["correct"]
    assert r["checks"]["archives_unlike"]["value"] == 1
    assert r["checks"]["bytes_wrong"]["value"] == 0
