"""The benchmark's files: BENCHMARK.json is what its data files say, it
keeps to the format's limits, the harness and the reference import
nothing they must not, and a cell and a metric added as files only, in a
copy of the benchmark, are found and run."""

import json
import os
import re
import shutil
import subprocess
import sys

from portbench import spec as SP
from portbench.tests.tiny import tiny_spec, write

REPO = os.path.dirname(SP.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_is_written_from_the_files():
    assert bench() == SP.Spec().benchmark()


def test_benchmark_json_keeps_to_its_format():
    b = bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert len(json.dumps(b)) < 64 * 1024
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert b["paths"] == ["portbench"] and len(b["command"]) <= 32
    assert all(os.path.exists(os.path.join(REPO, c["file"]))
               and c["file"].startswith("portbench/") for c in b["configs"])
    cells = {w["name"] for w in b["workloads"]}
    assert {w["config"] for w in b["workloads"]} == {c["name"]
                                                     for c in b["configs"]}
    # a metric that lists no cells is reported by every cell
    metrics = [dict(m, workloads=m.get("workloads", sorted(cells)))
               for m in b["end_to_end"] + b["per_layer"]]
    names = [x["name"] for x in b["configs"] + b["workloads"] + metrics]
    assert len(names) == len(set(names))
    for x in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(x), x
    for w in b["workloads"]:
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= cells
    e2e = {m["name"]: m for m in metrics if "bound" in m}
    assert "setup_s" in e2e and set(e2e["setup_s"]["workloads"]) == cells
    assert all("workloads" not in m for m in b["end_to_end"]
               if m["name"] == "setup_s")
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in metrics:
        if m["name"] in e2e:
            continue
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])
        assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200
        if m["name"].split(".")[0].endswith("roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m for m in metrics if cell in m["workloads"]]
        assert any(m["name"] != "setup_s" for m in reported
                   if m["name"] in e2e)
        assert any(m["name"] not in e2e for m in reported)
        assert any(m["name"].startswith("mfu") for m in reported)


PROBE = """
import sys, json
sys.path[:0] = [{root!r}, {repo!r}]
import torch
torch.set_num_threads(1)
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def probe(body, root=REPO, cwd=REPO):
    res = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=root, repo=REPO, body=body)],
                         capture_output=True, text=True, cwd=cwd,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_a_run_imports_neither_jax_nor_the_jax_package(tmp_path):
    """Whole top-level names: vitrs_tpu_torch is not vitrs_tpu."""
    body = (f"from portbench import harness\n"
            f"from portbench.tests.tiny import tiny_spec\n"
            f"spec = tiny_spec({str(tmp_path)!r})\n"
            f"line = harness.run_cell('gpt2-124m.train', 5, 0.2, False, 0.0,"
            f" 'cpu', spec)\n"
            f"assert line['correct'], line\n"
            f"assert harness.forbidden_modules() == []")
    mods = probe(body)
    assert "vitrs_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "vitrs_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    body = ("import portbench.reference.model, portbench.reference.train, "
            "portbench.reference.compare, portbench.reference.layout, "
            "portbench.yardstick.flops, portbench.yardstick.work, "
            "portbench.yardstick.groups, portbench.yardstick.peaks")
    mods = probe(body)
    assert not mods & {"vitrs_tpu_torch", "vitrs_tpu", "jax", "jaxlib"}


def test_the_command_refuses_to_run_without_a_card():
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "vit-b-16.infer", "--seed", "3", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=REPO, env=dict(os.environ,
                                            CUDA_VISIBLE_DEVICES=""),
                         timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA device" in res.stderr


def test_a_cell_and_a_metric_added_as_files_only_are_found_and_run(
        tmp_path):
    """In a copy of the benchmark: a new traffic mix of an existing generator
    (a workload file), and a new per-layer metric with its own reader
    module, are found by name and reported; nothing else is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(SP.ROOT, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = tiny_spec(root)
    wl = spec.workload("gpt2-124m.train")
    wl.update(name="gpt2-124m.train-b2", traffic="lm-b2", order=99,
              why="a second batch size, added as a file",
              reports=["train_tok_s", "setup_s", "steps_run.gpt_train_b2"])
    wl["params"]["batch"] = 2
    write(wl, root / "portbench" / "workloads" / "gpt2-124m.train-b2.json")
    write({"name": "steps_run.gpt_train_b2", "kind": "per_layer",
           "unit": "steps", "better": "higher", "source": "program_counter",
           "layer": "train step and forward", "moves": "train_tok_s",
           "reader": "steps.count",
           "args": {}, "order": 999},
          root / "portbench" / "metrics" / "steps_run.gpt_train_b2.json")
    (root / "portbench" / "readers" / "steps.py").write_text(
        "def count(ctx, out, summary, metric):\n"
        "    return float(out.work['steps'])\n")
    body = ("from portbench import harness, spec as SP\n"
            "import json\n"
            "spec = SP.Spec()\n"
            "b = spec.benchmark()\n"
            "assert 'gpt2-124m.train-b2' in [w['name'] for w in "
            "b['workloads']]\n"
            "line = harness.run_cell('gpt2-124m.train-b2', 9, 0.2, True, "
            "0.0, 'cpu', spec)\n"
            "assert line['correct'], line\n"
            "assert line['metrics']['steps_run.gpt_train_b2']['value'] > 0\n"
            "line = harness.run_cell('gpt2-124m.train-b2', 9, 0.2, False, "
            "0.0, 'cpu', spec)\n"
            "assert set(line['metrics']) == {'train_tok_s', 'setup_s'}\n")
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*.json")
              if p.name != "gpt2-124m.train-b2.json"}
    mods = probe(body, root=str(root), cwd=str(root))
    assert "portbench" in mods
    assert all(p.read_bytes() == b for p, b in before.items())
