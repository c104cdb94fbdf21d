"""Each traffic generator end to end on the CPU at tiny widths (gpt-nano;
vit-tiny-4-cifar10 at 2 layers), through the harness's `run_cell`, held
to `portbench/reference` by the cells' own limits; and the result line's
shape.

    python -m pytest portbench/tests -q
"""

import json

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import tiny_spec

CELLS = ("gpt2-124m.train", "vit-b-16.train", "gpt2-124m.prefill",
         "vit-b-16.infer")
SEED = 2**31 + 977          # past 32 signed bits, as a check's are


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_spec(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(spec, cell):
    logged = []
    line = harness.run_cell(cell, SEED, 0.5, False, 0.0, "cpu", spec,
                            log=logged.append)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    e2e = {m["name"] for m in spec.metrics_for(cell, "end_to_end")}
    assert set(line["metrics"]) == e2e and "setup_s" in e2e
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == set(spec.workload(cell)["limits"])
    json.dumps(line)
    # a rate is every example of every step or batch over the whole window
    note = json.loads(logged[-1])
    p = spec.workload(cell)["params"]
    if cell.endswith("train"):
        per = p["batch"] * (16 if cell.startswith("gpt") else 1)
        rate = line["metrics"]["train_tok_s" if cell.startswith("gpt")
                               else "train_img_s"]["value"]
        assert rate == note["steps"] * per / note["window_s"]
    elif cell.endswith("infer"):
        assert line["metrics"]["infer_img_s"]["value"] == \
            note["batches"] * p["batch"] / note["window_s"]
    else:
        assert note["served"] == note["requests"] == line["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_gives_breakdown_and_counters(spec, cell):
    line = harness.run_cell(cell, SEED + 1, 0.3, True, 0.0, "cpu", spec)
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "checks"
    # no device here: every device-trace reader finds nothing to read and
    # its metric is left out; a program counter is still read
    names = set(line["metrics"])
    assert names <= {m["name"] for m in spec.metrics_for(cell, "per_layer")}
    if cell.endswith("prefill"):
        assert names == {"prefill_tokens_per_pass.gpt_prefill"}
        assert line["metrics"]["prefill_tokens_per_pass.gpt_prefill"][
            "value"] >= 2
    else:
        assert names == set()


def test_same_seed_same_inputs(spec):
    """The schedule and the weights come from the seed alone."""
    from portbench import weights as W
    from portbench.shape import Shape
    from portbench.traffic import prefill
    s = Shape.from_config(spec.config("gpt2-124m"))
    p = spec.workload("gpt2-124m.prefill")["params"]
    a, b = (prefill.schedule(p, 2.0, SEED, 97) for _ in range(2))
    assert (a[0] == b[0]).all() and (a[1] == b[1]).all()
    assert all((x == y).all() for x, y in zip(a[2], b[2]))
    c = prefill.schedule(p, 2.0, SEED + 1, 97)
    # another seed: the same lengths and gaps, in another order
    assert sorted(a[1]) == sorted(c[1]) and (a[1] != c[1]).any()
    assert sorted(a[0]) != sorted(c[0]) or (a[0] != c[0]).any()
    assert abs(a[0][-1] - c[0][-1]) < 1e-9
    wa, wb = (W.make_weights(s, SEED, "cpu") for _ in range(2))
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert not torch.equal(W.make_weights(s, SEED + 1, "cpu")["wte"],
                           wa["wte"])
