"""One run of one cell: the configuration and the cell found by name, the
cell's traffic generator (`portbench/traffic/<generator>.py`) run against
program, the cell's metrics (end-to-end with `--trace 0`, per-layer from
their readers with `--trace 1`), the comparison that decides `correct`,
and the result line.

`main` is the command: it refuses to run without as many CUDA devices as
the cell asks for, and refuses to print a result when the process holds a
module of JAX or of the JAX package once the window has closed.
`run_cell` is the rest of a run, device-agnostic, which the tests drive on
the CPU at tiny sizes.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import subprocess
import sys
from typing import List, Optional

import torch

from . import spec as SP
from .reference import compare
from .shape import Shape
from .tracing import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "vitrs_tpu")


@dataclasses.dataclass
class Ctx:
    cell: str
    workload: dict
    config: dict
    shape: Shape
    cfg: object            # the program's config
    params: dict           # the workload's traffic parameters
    seed: int
    seconds: float
    tracer: Tracer
    device: str
    device_name: str
    t_start: float
    marks: dict = dataclasses.field(default_factory=dict)

    def mark(self, name: str):
        """Record the seconds since the process started at a point of the
        set-up (printed with the run's notes)."""
        import time
        self.marks[name] = time.perf_counter() - self.t_start


def program_config(conf: dict, s: Shape):
    """The program's config for a configuration file: its preset in its
    dtype, with any `overrides`; raises where a size differs from the
    file's shape."""
    from vitrs_tpu_torch.config import get_config
    cfg = get_config(conf["preset"], dtype=conf["dtype"],
                     **conf.get("overrides", {}))
    for field in ("mode", "num_layers", "channels", "num_heads",
                  "max_seq_len", "act"):
        if getattr(cfg, field) != getattr(s, field):
            raise ValueError(f"{conf['name']}: {field} is {getattr(s, field)}"
                             f" in the file, {getattr(cfg, field)} in the "
                             f"program's preset")
    if s.mode == "gpt" and cfg.vocab_size != s.vocab_size:
        raise ValueError(f"{conf['name']}: vocab_size differs")
    if s.mode == "vit" and (cfg.img_size, cfg.patch_size, cfg.num_classes) \
            != (s.img_size, s.patch_size, s.num_classes):
        raise ValueError(f"{conf['name']}: image geometry differs")
    if cfg.num_experts or cfg.num_kv_heads or cfg.window \
            or cfg.pos_emb != "learned":
        raise ValueError(f"{conf['name']}: the reference is dense MHA with "
                         f"learned positions")
    return cfg


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _reader(name: str):
    module, func = name.rsplit(".", 1)
    return getattr(importlib.import_module(f"portbench.readers.{module}"),
                   func)


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             spec: Optional[SP.Spec] = None, log=None) -> dict:
    """Run the cell once and return the result line (a dict)."""
    spec = spec or SP.Spec()
    wl = spec.workload(cell)
    conf = spec.config(wl["config"])
    s = Shape.from_config(conf)
    cfg = program_config(conf, s)
    cuda = torch.device(device).type == "cuda"
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    if cuda:
        torch.zeros(1, device=device)
    ctx = Ctx(cell, wl, conf, s, cfg, wl["params"], int(seed),
              float(seconds), Tracer(trace, cuda), device, name, t_start)
    ctx.mark("program_config_and_device")
    gen = importlib.import_module(f"portbench.traffic.{wl['generator']}")
    out = gen.run(ctx)
    checks = compare.check(out.numbers, wl["limits"])
    metrics = {}
    summary = ctx.tracer.summary() if trace else None
    if trace:
        for m in spec.metrics_for(cell, "per_layer"):
            value = _reader(m["reader"])(ctx, out, summary, m)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.metrics_for(cell, "end_to_end"):
            value = out.setup_s if m["name"] == "setup_s" \
                else out.e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": wl["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": all(c["ok"] for c in checks.values()),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        line["breakdown"] = {"device_ops": [list(x) for x in
                                            summary.device_ops],
                             "idle_gaps": [list(x) for x in
                                           summary.idle_gaps]}
    line["checks"] = {k: [c["value"], c["limit"]] for k, c in checks.items()}
    if log is not None:
        log(json.dumps({"cell": cell, "seed": int(seed), "setup_s":
                        out.setup_s, "numbers": out.numbers,
                        "counters": out.counters, "setup_marks": ctx.marks,
                        **out.notes,
                        **({"trace_events": summary.events}
                           if summary is not None else {})}))
    return line


def _smi() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main(argv=None, t_start: float = 0.0) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = SP.Spec()
    wl = spec.workload(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: the cell needs {wl['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    line = run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace), t_start, "cuda", spec,
                    log=lambda s: print(s, flush=True))
    print(f"card: {_smi()}", flush=True)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}: no result",
              file=sys.stderr)
        return 3
    for k, (value, limit) in line["checks"].items():
        print(f"check {k} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
