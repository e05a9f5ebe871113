"""A later change adds a cell and a metric by adding files and entries:
a traffic file and a metric file dropped into a copy of portbench/ are
picked up with no other edit."""

import json
import os
import shutil

from portbench import spec

METRIC = '''"""A metric a later change adds."""


def read(run):
    return 42.0
'''


def test_new_files_are_found(tmp_path, bench):
    root = tmp_path / "portbench"
    shutil.copytree(spec.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "metrics" / "detect.new_ms.py").write_text(METRIC)
    traffic = json.loads((root / "traffic" /
                          "detect_384x1280_b64.json").read_text())
    traffic["batch"] = 8
    (root / "traffic" / "detect_384x1280_b8.json").write_text(
        json.dumps(traffic))
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "detect.fullalign.b8",
                               "config": "m3dssd-fullalign-dla102",
                               "traffic": "detect_384x1280_b8", "chips": 1,
                               "why": "a later cell"})
    bench["per_layer"].append({"name": "detect.new_ms", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves":
                               "detect_images_per_s",
                               "workloads": ["detect.fullalign.b8"]})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("detect.fullalign.b8")
    shutil.copy(os.path.join(os.path.dirname(spec.HERE),
                             "portbench/configs/m3dssd-fullalign-dla102.json"),
                root / "configs")
    bench["configs"][0]["file"] = os.path.relpath(
        root / "configs" / "m3dssd-fullalign-dla102.json", tmp_path)
    cell = spec.Cell(bench, "detect.fullalign.b8", root=str(root))
    assert cell.traffic["batch"] == 8
    assert cell.limits == {}
    assert [m["name"] for m in cell.per_layer()] == ["detect.new_ms"]
    assert cell.reader("detect.new_ms").read(None) == 42.0
