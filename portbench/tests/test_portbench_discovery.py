"""The harness finds cells, configurations, drivers and metrics by name, so
adding one takes only new files."""
import json
import shutil

from conftest import ROOT

from portbench import harness


def test_files_on_disk_match_benchmark_json():
    bench = harness.benchmark()
    found = harness.listing()
    assert {c["name"] for c in bench["configs"]} <= set(found["configs"])
    assert {w["name"] for w in bench["workloads"]} <= set(found["workloads"])
    assert {m["name"] for m in bench["per_layer"]} <= set(found["metrics"])
    for w in bench["workloads"]:
        cell = harness.cell(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell["driver"] in found["traffic"]
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()


def test_new_cell_config_and_metric_are_found_from_new_files(tmp_path):
    base = tmp_path / "portbench"
    for kind in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(harness.HERE / kind, base / kind)
    config = harness.config("sgmse-plus-16k")
    config["name"] = "new-model"
    (base / "configs" / "new-model.json").write_text(json.dumps(config))
    cell = harness.cell("sgmse-plus-16k.enhance-b16")
    cell.update(name="new-model.enhance-b4", config="new-model")
    (base / "workloads" / "new-model.enhance-b4.json").write_text(json.dumps(cell))
    (base / "metrics" / "enhance.new_share_pct.py").write_text(
        "def read(ctx):\n    return 100.0 * ctx['window']['audio_samples'] / "
        "ctx['window']['padded_samples']\n")
    listed = harness.listing(base)
    assert "new-model" in listed["configs"]
    assert "new-model.enhance-b4" in listed["workloads"]
    assert "enhance.new_share_pct" in listed["metrics"]
    assert harness.config("new-model", base)["name"] == "new-model"
    assert harness.cell("new-model.enhance-b4", base)["config"] == "new-model"
    bench = harness.benchmark()
    bench["workloads"].append(dict(name="new-model.enhance-b4", config="new-model",
                                   traffic="enhance-b16", chips=1, why="test"))
    for m in bench["end_to_end"]:
        if "workloads" in m and "sgmse-plus-16k.enhance-b16" in m["workloads"]:
            m["workloads"].append("new-model.enhance-b4")
    bench["per_layer"].append(dict(name="enhance.new_share_pct", unit="%", better="higher",
                                   source="program_counter", layer="entry point",
                                   moves="enhance_audio_s_per_s"))
    names = [m["name"] for m in harness.per_layer(bench, "new-model.enhance-b4")]
    assert "enhance.new_share_pct" in names
    assert "enhance.new_share_pct" in [m["name"] for m in
                                       harness.per_layer(bench, "sgmse-plus-16k.enhance-b16")]
    assert "enhance.new_share_pct" not in [m["name"] for m in
                                           harness.per_layer(bench, "sgmse-sb-16k.train-b16")]
    reader = harness.reader("enhance.new_share_pct", base)
    ctx = {"window": {"audio_samples": 90, "padded_samples": 100}}
    assert reader.read(ctx) == 90.0


def test_every_reported_metric_has_a_reader_and_every_cell_reports_setup():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.end_to_end(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.per_layer(bench, w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in e2e
            assert callable(harness.reader(m["name"]).read)
