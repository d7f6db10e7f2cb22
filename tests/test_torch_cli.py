"""The port's CLI flags --cpu and --profile against fastqueeze_tpu's CLI.

``--cpu`` runs the port on the CPU (the kernels' plain versions and the
native host coders, as api.py does with device="cpu"): its archives
equal the JAX CLI's byte for byte, SE and PE, and it restores the JAX
CLI's archive.  ``--profile DIR`` writes a torch.profiler trace (a Chrome
trace with events) and changes no archive byte; a profiler that does not
start stops the run.  Without --cpu and without a card the CLI is still
refused (tests/test_torch_pipeline.py).  Inputs are seeded FASTQ of a
few thousand reads; every comparison is byte for byte.
"""

import json
import os

import numpy as np
import pytest
import torch

from fastqueeze_tpu import cli as jcli
from fastqueeze_tpu_torch import cli


def _fastq(rng, n: int, mate: int = 0) -> bytes:
    """n seeded reads of 60-120 bp, a few N bases, random-walk qualities
    over four bins, SRA-style IDs."""
    bins = np.array([2, 12, 24, 37])
    recs = []
    for r in range(n):
        L = int(rng.integers(60, 121))
        seq = bytearray(b"ACGT"[c] for c in rng.integers(0, 4, L))
        if r % 23 == mate:
            seq[L // 3] = ord("N")
        walk = np.clip(np.cumsum(rng.integers(-1, 2, L)) + 2, 0, 3)
        recs.append(b"@SRR0000018.%d %d length=%d\n" % (r + 1, r + 1, L)
                    + bytes(seq) + b"\n+\n"
                    + bytes((bins[walk] + 33).astype(np.uint8)) + b"\n")
    return b"".join(recs)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """SE: 3,000 reads; PE: 1,500 pairs."""
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(18)
    paths = {}
    for name, n, mate in (("se", 3000, 0), ("pe_1", 1500, 0),
                          ("pe_2", 1500, 1)):
        paths[name] = str(d / f"{name}.fq")
        with open(paths[name], "wb") as fh:
            fh.write(_fastq(rng, n, mate))
    return paths


def _ins(inputs, kind):
    if kind == "se":
        return ["-1", inputs["se"]]
    return ["-1", inputs["pe_1"], "-2", inputs["pe_2"]]


@pytest.mark.parametrize("kind", ["se", "pe"])
def test_cli_cpu_writes_the_jax_archive(inputs, kind, tmp_path):
    """-c --cpu == the JAX CLI's archive byte for byte, and -d --cpu of
    the JAX archive restores the input."""
    ja, ta = str(tmp_path / "j.fqz"), str(tmp_path / "t.fqz")
    assert jcli.main(["-c"] + _ins(inputs, kind) + ["-o", ja]) == 0
    assert cli.main(["-c", "--cpu"] + _ins(inputs, kind) + ["-o", ta]) == 0
    with open(ja, "rb") as a, open(ta, "rb") as b:
        assert a.read() == b.read()
    back = str(tmp_path / "back")
    assert cli.main(["-d", "--cpu", ja, "-o", back]) == 0
    outs = ([back + ".fastq"] if kind == "se"
            else [back + "_1.fastq", back + "_2.fastq"])
    srcs = [inputs["se"]] if kind == "se" else [inputs["pe_1"],
                                                inputs["pe_2"]]
    for got, src in zip(outs, srcs):
        with open(got, "rb") as a, open(src, "rb") as b:
            assert a.read() == b.read()


def test_cli_profile_writes_a_trace_and_no_byte(inputs, tmp_path, capsys):
    """--cpu --profile DIR: the trace parses as JSON with events (the
    command's span; on the CPU the native coders run outside torch), the
    archive equals the one written without --profile, and the run logs
    where the trace went."""
    plain, traced = str(tmp_path / "a.fqz"), str(tmp_path / "b.fqz")
    prof = str(tmp_path / "prof")
    assert cli.main(["-c", "--cpu"] + _ins(inputs, "se") + ["-o", plain]) == 0
    assert cli.main(["-c", "--cpu", "--profile", prof] + _ins(inputs, "se")
                    + ["-o", traced]) == 0
    with open(plain, "rb") as a, open(traced, "rb") as b:
        assert a.read() == b.read()
    with open(os.path.join(prof, cli.TRACE_NAME)) as fh:
        trace = json.load(fh)
    spans = [e for e in trace["traceEvents"]
             if e.get("name") == cli.RUN_SPAN and e.get("ph") == "X"]
    assert len(spans) == 1 and spans[0]["dur"] > 0
    assert f"profiler trace written to {prof}" in capsys.readouterr().err


def test_cli_profile_is_written_when_the_run_fails(tmp_path, capsys):
    """A failing run (a missing archive) still writes its trace."""
    prof = str(tmp_path / "prof")
    assert cli.main(["-d", "--cpu", "--profile", prof,
                     str(tmp_path / "missing.fqz"), "-o",
                     str(tmp_path / "x")]) == 1
    assert os.path.exists(os.path.join(prof, cli.TRACE_NAME))


def test_cli_profile_that_does_not_start_stops_the_run(tmp_path, capsys,
                                                       monkeypatch):
    def refuse(*_a, **_k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    out = str(tmp_path / "x.fqz")
    assert cli.main(["-c", "--cpu", "--profile", str(tmp_path / "p"), "-1",
                     "a.fq", "-o", out]) == 2
    assert "profiler did not start: no profiler here" in (
        capsys.readouterr().err)
    assert not os.path.exists(out)


def test_cli_cpu_mesh_says_what_the_api_says(inputs, tmp_path, capsys):
    """--mesh 2 --cpu: one CPU device, refused with api.py's message."""
    assert cli.main(["-c", "--cpu", "--mesh", "2"] + _ins(inputs, "se")
                    + ["-o", str(tmp_path / "x.fqz")]) == 1
    assert "--mesh 2: only 1 device(s) visible" in capsys.readouterr().err


def test_cli_has_every_flag_of_the_jax_cli():
    def flags(ap):
        return {s for a in ap._actions for s in a.option_strings}

    assert flags(jcli.build_parser()) <= flags(cli.build_parser())
    a = cli.build_parser().parse_args(["-d", "x.fqz", "--cpu",
                                       "--profile", "t"])
    assert (a.cpu, a.profile) == (True, "t")
