"""BENCHMARK.json against the benchmark's contract, and discovery by name:
every configuration, mix, per-layer metric and kernel count is a file
found from its name, and a cell added in a temporary copy as data only
(a configuration, a mix, a metric reader and manifest entries) runs with
no change to the harness's code."""

import json
import os
import re
import shutil
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from fqbench import harness  # noqa: E402
from conftest import tiny  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
MAN = harness.load_manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "fqbench/run.py"]
    assert MAN["paths"] == ["fqbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert all(_line(w) for w in MAN["command"])
    # a full check of 24 cells fits 43,200 s
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(MAN)) <= 64 << 10


def test_configs():
    used = {w["config"] for w in MAN["workloads"]}
    files = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("fqbench/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(harness.ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        # source and reduced live in the manifest alone; each reduced key
        # is a key of the file, which says how it was cut
        assert "source" not in cfg and "reduced" not in cfg
        assert set(c["reduced"]) <= set(cfg)
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16


def test_workloads():
    names = set()
    pairs = set()
    configs = {c["name"] for c in MAN["configs"]}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in names
        names.add(w["name"])
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert os.path.exists(os.path.join(
            harness.BENCH_DIR, "mixes", w["traffic"] + ".json"))
    assert 1 <= len(names) <= 24
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(names) // 4)


def test_metrics():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    seen = set()
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        mv = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= set(
            mv.get("workloads", cells))
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
        assert os.path.exists(os.path.join(
            harness.BENCH_DIR, "metrics", m["name"] + ".py")), m["name"]
    assert all(len(v) == 1 for v in layers.values()), layers
    for cell in cells:
        c = harness.load_cell(cell)
        assert any(m["name"] != "setup_s" for m in c.end_to_end)
        assert c.per_layer


def test_every_metric_reader_loads():
    cell = harness.load_cell("se_default.roundtrip")
    for m in MAN["per_layer"]:
        assert callable(cell.reader(m["name"]))


def _add_cell(tmp_path, kind="se"):
    """A copy of the benchmark with a cell added as data only: a
    configuration (single-end, or paired through compress_pe), a mix, a
    metric reader and manifest entries."""
    root = tmp_path / "checkout"
    bench = root / "fqbench"
    shutil.copytree(harness.BENCH_DIR, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "_cache", "tests"))
    man = json.loads(json.dumps(MAN))
    cfg = json.load(open(os.path.join(harness.BENCH_DIR, "configs",
                                      "se_default.json")))
    cfg.update(params={"use_model": 1, "block_bytes": 100_000})
    cfg["reads"]["genome_bp"] = 1_000_000
    if kind == "pe":
        cfg["entry"] = "compress_pe"
        cfg["reads"].update(kind="pe", insert_min=200, insert_max=500)
    (bench / "configs" / "se_small.json").write_text(json.dumps(cfg))
    (bench / "mixes" / "files.json").write_text(json.dumps(
        {"threads": 2, "reads_per_file": 1500, "reference": "roundtrip"}))
    (bench / "metrics" / "driver.reads_per_job.py").write_text(
        "def read(ctx):\n    return ctx.dbg['compress'].get('reads')\n")
    man["configs"].append(dict(man["configs"][0], name="se_small",
                               file="fqbench/configs/se_small.json"))
    man["workloads"].append({"name": "se_small.files", "config": "se_small",
                             "traffic": "files", "chips": 1,
                             "why": "a cell added as data"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("se_small.files")
    man["per_layer"].append({"name": "driver.reads_per_job", "unit": "reads",
                             "better": "higher", "source": "program_counter",
                             "layer": "driver (pipeline/driver.py)",
                             "moves": "compress_MBps",
                             "workloads": ["se_small.files"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return str(root), str(bench)


@pytest.mark.parametrize("kind", ("se", "pe"))
def test_a_cell_added_as_data_runs(tmp_path, kind):
    root, bench = _add_cell(tmp_path, kind)
    cell = harness.load_cell("se_small.files", root, bench)
    assert cell.mix["threads"] == 2
    assert harness.make_params(cell).threads == 2
    r = harness.run_cell(cell, 2**31 + 1, 0.5, False, "cpu")
    assert r["correct"] and set(r["metrics"]) == {
        "compress_MBps", "decompress_MBps", "ratio", "setup_s"}
    assert r["checks"]["archives_unlike"] == {"value": 0, "limit": 0}
    r = harness.run_cell(cell, 2**31 + 1, 0.5, True, "cpu")
    assert r["correct"]
    reads = 1500 * (2 if kind == "pe" else 1)
    assert r["metrics"]["driver.reads_per_job"]["value"] == reads
    assert r["metrics"]["driver.reads_per_job"]["unit"] == "reads"


def test_the_existing_cells_still_resolve_in_the_copy(tmp_path):
    root, bench = _add_cell(tmp_path)
    for name in ("se_default.roundtrip", "se_q3.roundtrip"):
        a = harness.load_cell(name, root, bench)
        b = harness.load_cell(name)
        assert a.config == b.config and a.mix == b.mix
        assert [m["name"] for m in a.per_layer] == [
            m["name"] for m in b.per_layer]


@pytest.mark.parametrize("name", ("se_default.roundtrip", "se_q3.roundtrip"))
def test_traced_tiny_run_reports_the_cells_metrics(name):
    """On the CPU a traced run has no device records: the readers of
    device metrics find nothing and are left out, the rest report."""
    r = harness.run_cell(tiny(name), 17, 0.5, True, "cpu")
    assert r["correct"] and "busy_s" in r["device"]
    want = {m["name"] for m in harness.load_cell(name).per_layer
            if m["source"] != "device_trace"}
    assert want <= set(r["metrics"])


@pytest.mark.parametrize("mix", [{"loop": "open"}, {"clients": 4},
                                 {"ops": ["compress"]}])
def test_a_mix_key_the_harness_does_not_read_is_refused(tmp_path, mix):
    root, bench = _add_cell(tmp_path)
    with open(os.path.join(bench, "mixes", "files.json"), "w") as fh:
        json.dump(dict(mix, threads=1, reads_per_file=10,
                       reference="roundtrip"), fh)
    with pytest.raises(ValueError, match="not read by the harness"):
        harness.load_cell("se_small.files", root, bench)


def test_a_mix_without_its_reference_is_refused(tmp_path):
    root, bench = _add_cell(tmp_path)
    with open(os.path.join(bench, "mixes", "files.json"), "w") as fh:
        json.dump({"threads": 1, "reads_per_file": 10,
                   "reference": "lossy"}, fh)
    with pytest.raises(ValueError, match="no reference/lossy.py"):
        harness.load_cell("se_small.files", root, bench)


@pytest.mark.parametrize("edit, match", [
    ({"cli": ["-c"]}, "not read by the harness"),
    ({"entry": "extract"}, "unknown entry"),
    ({"entry": "compress_pe"}, "takes 2 files"),
    ({"reads": {"kind": "long", "length": 100}}, "unknown kind"),
    ({"reads": {"kind": "se", "length": 100, "insert_min": 200}},
     "not read by kind"),
])
def test_a_config_the_harness_cannot_run_is_refused(tmp_path, edit, match):
    root, bench = _add_cell(tmp_path)
    path = os.path.join(bench, "configs", "se_small.json")
    cfg = dict(json.load(open(path)), **edit)
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    with pytest.raises(ValueError, match=match):
        harness.load_cell("se_small.files", root, bench)
