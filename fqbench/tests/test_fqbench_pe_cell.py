"""The cell pe_default.roundtrip of the manifest on the CPU, cut to a tiny
size (2,000 pairs over a 1 Mbp genome in blocks of 100 kB, the frozen
path forced on): a sound run is correct and reports the end-to-end
metrics; the control and mates restored swapped are not correct; a traced
run reads every pe.* metric; and a job's archive has the block table and
file MD5s of reference/pe_layout.py."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from fqbench import harness  # noqa: E402
from fqbench.reference import pe_layout  # noqa: E402
from conftest import tiny  # noqa: E402
from fastqueeze_tpu_torch.pipeline import driver  # noqa: E402

CELL = "pe_default.roundtrip"
BLOCK = 100_000
PE_METRICS = ("pe.pair_ms_per_MB.compress", "pe.pair_ms_per_MB.decompress",
              "pe.serialize_ms_per_MB", "pe.unspanned_share.compress",
              "pe.unspanned_share.decompress")


def _tiny():
    cell = tiny(CELL)
    cell.config["params"].update(use_model=1, block_bytes=BLOCK)
    return cell


def test_the_cell_is_in_the_manifest():
    cell = harness.load_cell(CELL)
    assert cell.chips == 1 and cell.config["entry"] == "compress_pe"
    assert cell.config["params"] == {} and cell.mix["reads_per_file"] == \
        400_000
    assert set(PE_METRICS) <= {m["name"] for m in cell.per_layer}
    assert {m["name"] for m in cell.end_to_end} == {
        "compress_MBps", "decompress_MBps", "ratio", "setup_s"}


def test_sound_run_is_correct():
    r = harness.run_cell(_tiny(), 2**31 + 5, 0.5, False, "cpu")
    assert r["correct"] and r["failed"] == 0
    assert set(r["metrics"]) == {"compress_MBps", "decompress_MBps",
                                 "ratio", "setup_s"}


def test_control_lossy_is_not_correct():
    r = harness.run_cell(_tiny(), 2**31 + 5, 0.5, False, "cpu",
                         control="lossy")
    assert not r["correct"] and r["checks"]["bytes_wrong"]["value"] > 0


def test_mates_restored_swapped_are_not_correct(monkeypatch):
    real_job, real = harness.run_job, driver.decompress

    def swapped(arc, prefix, **kw):
        out = real(arc, prefix + ".plain", **kw)
        for src, dst in zip(out, (prefix + "_2.fastq", prefix + "_1.fastq")):
            with open(src, "rb") as a, open(dst, "wb") as b:
                b.write(a.read())
            os.remove(src)
        return out

    def run_job(cell, work, inp, k, device, control=None, span=None):
        if k == 0:
            return real_job(cell, work, inp, k, device, control, span)
        with monkeypatch.context() as m:
            m.setattr(driver, "decompress", swapped)
            return real_job(cell, work, inp, k, device, control, span)

    monkeypatch.setattr(harness, "run_job", run_job)
    r = harness.run_cell(_tiny(), 2**31 + 9, 0.5, False, "cpu")
    assert not r["correct"] and r["checks"]["bytes_wrong"]["value"] > 0


def test_a_traced_run_reads_every_pe_metric():
    r = harness.run_cell(_tiny(), 17, 0.5, True, "cpu")
    assert r["correct"]
    got = r["metrics"]
    assert set(PE_METRICS) <= set(got), sorted(set(PE_METRICS) - set(got))
    assert all(got[m]["value"] >= 0 for m in PE_METRICS)
    assert got["pe.pair_ms_per_MB.compress"]["value"] > 0
    assert got["pe.pair_ms_per_MB.decompress"]["value"] > 0


@pytest.mark.parametrize("seed", (3, 2**31 + 11))
def test_a_jobs_archive_has_the_references_layout(tmp_path, seed):
    from fastqueeze_tpu_torch.container.arcfile import ArcReader
    from fastqueeze_tpu_torch.utils.metrics import DebugInfo
    cell = _tiny()
    inp = harness.make_input(cell, seed)
    arc, _, _ = harness.compress_files(cell, str(tmp_path), inp, 1, "cpu",
                                       None, DebugInfo())
    with ArcReader(arc) as reader:
        blocks = [pe_layout.BlockPair(b.n_reads, b.raw_len1, b.raw_len2,
                                      b.md5) for b in reader.blocks]
        md5s = list(reader.input_md5s)
    want, want_md5s = pe_layout.layout(inp.expected(1, 0), inp.expected(1, 1),
                                       BLOCK)
    assert len(want) >= 3 and blocks == want and md5s == want_md5s
