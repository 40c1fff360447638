"""A cell and a per-layer metric are added as files and entries alone: the
harness finds them by name, and no file it already has changes."""
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import json, sys
sys.path.insert(0, '.')
from perfbench.harness import Cell, execute
from perfbench.tests.conftest import TINY
cell = Cell.named('qp2-photos-b4')
cell.config = dict(cell.config, **TINY['qp2_msssim'])
result = execute(cell, 2**40 + 3, 1.0, True, 'cpu')
print(json.dumps({'traffic': cell.traffic, 'perLayer': [m['name'] for m in cell.perLayer],
                  'metrics': result['metrics'], 'correct': result['correct']}))
"""


def digests(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_an_added_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "assets").symlink_to(ROOT / "assets")
    (tmp_path / "mcquic_tpu_torch").symlink_to(ROOT / "mcquic_tpu_torch")
    before = digests(tmp_path / "perfbench")

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "qp2-photos-b4", "config": "qp2_msssim",
                               "traffic": "photos-b4", "chips": 1, "why": "a probe"})
    bench["per_layer"].append({"name": "requests_probe.compress", "unit": "images",
                               "better": "higher", "source": "program_counter",
                               "layer": "engine", "moves": "compress_mpps",
                               "workloads": ["qp2-photos-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "perfbench/traffic/photos-b4.json").write_text(json.dumps(
        {"driver": "codec_batches", "batch": 2, "pool": 3, "sample": 1, "chunk": 2}))
    (tmp_path / "perfbench/layers/requests_probe.compress.py").write_text(
        "def read(run):\n    return run.attempted\n")

    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert found["traffic"]["batch"] == 2 and found["correct"]
    assert "requests_probe.compress" in found["perLayer"]
    assert found["metrics"]["requests_probe.compress"]["value"] >= 4
    after = digests(tmp_path / "perfbench")
    added = {"traffic/photos-b4.json", "layers/requests_probe.compress.py"}
    assert {k: v for k, v in after.items() if k not in added} == before
