"""A configuration, a traffic mix, a per-layer metric and a cell's limits
dropped in as new files, with new entries in BENCHMARK.json, are found by
name and run with no edit to a file that is already there."""

import json
import os
import shutil

from benchmark import harness

NEW_CONFIG = {
    "name": "two_spheres", "kind": "spheres",
    "source": "a test scene: a metal sphere on a diffuse ground sphere",
    "spheres": [
        {"center": [0.0, -100.5, -1.0], "radius": 100.0,
         "material": {"kind": "lambertian", "albedo": [0.5, 0.5, 0.5]}},
        {"center": [0.0, 0.0, -1.0], "radius": 0.5,
         "material": {"kind": "metal", "albedo": [0.8, 0.6, 0.2],
                      "fuzz": 0.3}}],
    "camera": {"eye": [0.0, 0.0, 0.5], "target": [0.0, 0.0, -1.0],
               "focal_length": 1.5, "focal_blur": 0.0, "fov_pi": 0.3},
    "bounces": 4, "reduced": [], "assumed": {}}
NEW_TRAFFIC = {
    "entry": "render", "why": "tiny converged images",
    "width": 16, "height": 12, "spp": 2, "frames_per_request": 2,
    "reset_each_request": True, "time_step": 10, "warmup_requests": 1,
    "trace_requests": 2, "check_pixels": 32}
NEW_METRIC = '''
def read(t):
    return float(t.requests) if t.unit == "image" else None
'''


def test_new_files_are_found_by_name(root, tmp_path):
    shutil.copytree(os.path.join(root, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache",
                                                  "tests"))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    b = tmp_path / "benchmark"
    (b / "configs" / "two_spheres.json").write_text(json.dumps(NEW_CONFIG))
    (b / "traffic" / "tiny-images.json").write_text(json.dumps(NEW_TRAFFIC))
    (b / "metrics" / "requests_traced.py").write_text(NEW_METRIC)
    (b / "limits" / "two-spheres-tiny.json").write_text(
        json.dumps({"limits": {"image_rel_l1": 1e-3}}))
    bench["configs"].append(
        {"name": "two_spheres", "source": "test", "reduced": [],
         "file": "benchmark/configs/two_spheres.json", "why": "test"})
    bench["workloads"].append(
        {"name": "two-spheres-tiny", "config": "two_spheres",
         "traffic": "tiny-images", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append("two-spheres-tiny")
    bench["per_layer"].append(
        {"name": "requests_traced", "unit": "images", "better": "higher",
         "source": "program_counter", "layer": "entry and dispatch",
         "moves": "images_per_s", "workloads": ["two-spheres-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    res = harness.run_cell(str(tmp_path), "two-spheres-tiny", 11, 0.05,
                           False, "cpu")
    assert res["correct"] and set(res["metrics"]) == {"images_per_s",
                                                      "setup_s"}
    res = harness.run_cell(str(tmp_path), "two-spheres-tiny", 12, 0.05, True,
                           "cpu")
    assert res["correct"]
    assert res["metrics"]["requests_traced"]["value"] == 2.0
    assert list(res)[-1] == "checks"
