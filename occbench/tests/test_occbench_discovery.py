"""A configuration, traffic mix or per-layer metric is added by files and
entries alone: a metric file dropped into a copy of the folder is found by
its name, and so are a new traffic and config file."""
import json
import os
import shutil
from types import SimpleNamespace

from occbench import run

ROOT = run.ROOT


def test_new_metric_and_traffic_found_by_name(tmp_path):
    pkg = tmp_path / "occbench"
    shutil.copytree(run.PKG, pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "metrics" / "answer.stream.py").write_text(
        "def read(ctx):\n    return 42.0 if ctx.kind == 'stream' "
        "else None\n")
    (pkg / "metrics" / "silent.py").write_text(
        "def read(ctx):\n    return None\n")
    (pkg / "traffic" / "burst.json").write_text(json.dumps(
        {"loop": "stream", "pool_frames": 2}))
    (pkg / "limits" / "lidar.burst.json").write_text(json.dumps(
        {"occ_rms": 0.1}))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "lidar.burst",
                               "config": "coocc_lidar",
                               "traffic": "burst", "chips": 1, "why": "x"})
    for name in ("answer.stream", "answer.stream.lidar", "silent"):
        bench["per_layer"].append(
            {"name": name, "unit": "count", "better": "higher",
             "source": "program_counter", "layer": "device",
             "moves": "frames_per_s", "workloads": ["lidar.burst"]})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("lidar.burst")
    spec = run.cell_spec(bench, "lidar.burst", pkg=str(pkg))
    assert spec.traffic["pool_frames"] == 2
    assert spec.limits == {"occ_rms": 0.1}
    assert {m["name"] for m in spec.per_layer} == {
        "answer.stream", "answer.stream.lidar", "silent"}
    got = run.read_per_layer(spec, SimpleNamespace(kind="stream"))
    # a name with no file of its own is read by its dotted prefix's reader
    assert got == {"answer.stream": {"value": 42.0, "unit": "count"},
                   "answer.stream.lidar": {"value": 42.0, "unit": "count"}}


def test_cell_reports_only_its_metrics():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        spec = run.cell_spec(bench, w["name"])
        e2e = {m["name"] for m in spec.e2e}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer
        for m in spec.per_layer:
            assert m["moves"] in e2e
            assert os.path.exists(run.reader_path(run.PKG, m["name"]))
