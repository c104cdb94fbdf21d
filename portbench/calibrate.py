"""The readings that a cell's limits are set from (PERF.md section 2), in
one process on the chip, at the cell's own sizes:

- the program's readings of every compared number, over `--seeds`;
- the control's, over `--control-seeds`: for a training cell the
  reference in fp8 (e4m3 operands) against the reference in fp32 from the
  same weights and batches; for a serving or inference cell the program's
  own int8 path (the engine on int8 weights, `ops/quant.quantize_params`;
  the w8a8 forward, `models/quantized.vit_forward_q`), and for the served
  token the gap of the int8 path's first token at each position of the
  checked prompts (`prefill_position_control`);
- for a training cell, the fault "half of the batch left out, the mean
  taken over the rest", planted under the harness (the step gets the
  first half of each batch), over the control seeds;
- for the prefill cell, the fault "a token altered where it is
  produced" (the engine's sampler returns the next id), over the control
  seeds: the served token's upper reading;
- for every cell, two faults in the weights the program's forward reads
  (`models/model.prepare_params`, `train_params`): layer 0's attention
  output bias dropped, and layers 0 and 1's first LayerNorm gains
  swapped, over the control seeds.

    python3 portbench/calibrate.py --workload gpt2-124m.train \\
        --seeds 1,2,3 --control-seeds 4,5,6 --seconds 0

Prints one JSON line a run and a summary: each number's largest program
reading and smallest control and fault readings.  The benchmark's own runs
never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _ctx(cell, seed, seconds, device="cuda"):
    from portbench import harness
    from portbench import spec as SP
    from portbench.shape import Shape
    from portbench.tracing import Tracer
    import torch
    spec = SP.Spec()
    wl = spec.workload(cell)
    conf = spec.config(wl["config"])
    s = Shape.from_config(conf)
    cfg = harness.program_config(conf, s)
    cuda = device != "cpu"
    return harness.Ctx(cell, wl, conf, s, cfg, wl["params"], seed,
                       float(seconds), Tracer(False, cuda), device,
                       torch.cuda.get_device_name(0) if cuda else "cpu",
                       time.perf_counter())


def program_run(cell, seed, seconds):
    import importlib
    ctx = _ctx(cell, seed, seconds)
    gen = importlib.import_module(
        f"portbench.traffic.{ctx.workload['generator']}")
    return gen.run(ctx).numbers


def train_control(cell, seed, device="cuda"):
    """fp8 reference against fp32 reference, same weights and batches."""
    from portbench import weights as W
    from portbench.reference import compare
    from portbench.reference import train as RT
    from portbench.reference.model import Ref, fp32_exact
    from portbench.traffic import train as TR
    import numpy as np
    ctx = _ctx(cell, seed, 0, device)
    s, p = ctx.shape, ctx.params
    fp32_exact()
    w0 = W.make_weights(s, seed, device)
    batches = [TR._batch(ctx, t) for t in range(1, p["checked_steps"] + 1)]
    hp = {k: p[k] for k in ("lr", "weight_decay", "clip_norm", "beta1",
                            "beta2", "eps")}
    norm = ((np.asarray(p["mean"], np.float32),
             np.asarray(p["std"], np.float32)) if s.mode == "vit" else None)
    ref = RT.follow(Ref(s, "fp32"), w0, batches, hp, p["ref_block"], norm)
    low = RT.follow(Ref(s, "fp8"), w0, batches, hp, p["ref_block"], norm)
    return compare.train_numbers(low, ref, s)


def half_batch_step(make):
    def build(*a, **k):
        step = make(*a, **k)

        def half(params, m, v, x, y, *rest):
            n = x.shape[0] // 2
            return step(params, m, v, x[:n], y[:n], *rest)
        return half
    return build


def altered_token(real):
    """The engine's sampler with its answer moved to the next token id."""
    def sample(self, req, logits):
        return (real(self, req, logits) + 1) % logits.shape[-1]
    return sample


def planted(fault, make):
    """`make` (prepare_params or train_params) with a fault in the dict of
    weights that the forward reads: "bias_dropped" takes layer 0's
    attention output bias out, "ln_gains_swapped" swaps layers 0 and 1's
    first LayerNorm gains."""
    def build(params, cfg, *a, **k):
        out = dict(make(params, cfg, *a, **k))
        if fault == "bias_dropped":
            b = out["attprojb"]
            keep = b.new_ones(b.shape[0], 1)
            keep[0] = 0
            out["attprojb"] = b * keep
        elif fault == "ln_gains_swapped":
            w = out["ln1w"]
            order = [1, 0] + list(range(2, w.shape[0]))
            out["ln1w"] = w[order]
        else:
            raise ValueError(fault)
        return out
    return build


WEIGHT_FAULTS = ("bias_dropped", "ln_gains_swapped")


def weight_fault_run(cell, seed, seconds, fault):
    from vitrs_tpu_torch.models import model as M
    with patched(M, "prepare_params", planted(fault, M.prepare_params)), \
            patched(M, "train_params", planted(fault, M.train_params)):
        return program_run(cell, seed, seconds)


def int8_engine(make):
    def build(cfg, weights, p, seed):
        from vitrs_tpu_torch.ops import quant
        return make(cfg, quant.quantize_params(weights, mode="gpt"), p, seed)
    return build


def prefill_position_control(cell, seed, device="cuda"):
    """The served-token number of the control, read as a served model's
    control is read: at each position of the checked prompts, the
    gap below the reference's best of the token the program's int8 path
    (`models/quantized.gpt_forward_q`, the engine's int8 weights) puts
    first.  The prompts are those a run's check draws."""
    import numpy as np
    import torch
    from portbench import weights as W
    from portbench.reference.model import Ref, fp32_exact
    from portbench.traffic import common as CM
    from portbench.traffic import prefill as PF
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.models import quantized as Q
    from vitrs_tpu_torch.ops import quant
    ctx = _ctx(cell, seed, 0, device)
    s, p = ctx.shape, ctx.params
    _, lens, prompts = PF.schedule(p, 3.0, seed, s.vocab_size)
    rng = np.random.default_rng([int(seed), 0xC4EC])
    picked = CM.sample(rng, list(range(len(prompts))), p["check_requests"],
                       always=[int(np.argmax(lens))])
    fp32_exact()
    w = W.make_weights(s, seed, device)
    qp = M.prepare_params(quant.quantize_params(w, mode="gpt"), ctx.cfg)
    ref = Ref(s, "fp32")
    widest = 0.0
    with torch.no_grad():
        for j in picked:
            tok = torch.as_tensor(prompts[j], device=device)[None]
            low = Q.gpt_forward_q(qp, tok, ctx.cfg)[0].float()
            want = ref.gpt_logits(w, ref.gpt_hidden(w, tok))[0]
            top = low[:, :s.vocab_size].argmax(dim=-1)
            gap = want.amax(dim=-1) - want.gather(-1, top[:, None])[:, 0]
            widest = max(widest, float(gap.max()))
    return {"token_gap": widest}


def w8a8_forward(cfg, weights, mean, std):
    import torch
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.models import quantized as Q
    from vitrs_tpu_torch.ops import quant
    from vitrs_tpu_torch.parallel import data_parallel as dp
    qp = M.prepare_params(quant.quantize_params(weights, mode="vit"), cfg)

    def forward(images):
        with torch.inference_mode():
            return Q.vit_forward_q(qp, dp.normalize_images(images, mean, std),
                                   cfg, w8a8=True)
    return forward


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    from portbench.spec import Spec
    from portbench.traffic import offline, prefill, train
    gen = Spec().workload(args.workload)["generator"]
    seeds = [int(x) for x in args.seeds.split(",") if x]
    cseeds = [int(x) for x in args.control_seeds.split(",") if x]
    runs = {"program": [], "control": [], "fault_half_batch": [],
            "fault_altered_token": [],
            **{f"fault_{f}": [] for f in WEIGHT_FAULTS}}

    def record(kind, seed, numbers):
        runs[kind].append(numbers)
        print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers}),
              flush=True)

    for seed in seeds:
        record("program", seed, program_run(args.workload, seed,
                                            args.seconds))
    for seed in cseeds:
        if gen == "train":
            record("control", seed, train_control(args.workload, seed))
            with patched(train, "program_step",
                         half_batch_step(train.program_step)):
                record("fault_half_batch", seed,
                       program_run(args.workload, seed, args.seconds))
        elif gen == "prefill":
            with patched(prefill, "program_engine",
                         int8_engine(prefill.program_engine)):
                numbers = program_run(args.workload, seed, args.seconds)
            numbers["token_gap_served"] = numbers.pop("token_gap")
            numbers.update(prefill_position_control(args.workload, seed))
            record("control", seed, numbers)
            from vitrs_tpu_torch.serving_gen import GenerationEngine as GE
            with patched(GE, "_sample_host", altered_token(GE._sample_host)):
                record("fault_altered_token", seed,
                       program_run(args.workload, seed, args.seconds))
        else:
            with patched(offline, "program_forward", w8a8_forward):
                record("control", seed, program_run(args.workload, seed,
                                                    args.seconds))
        for fault in WEIGHT_FAULTS:
            record(f"fault_{fault}", seed,
                   weight_fault_run(args.workload, seed, args.seconds, fault))
    summary = {}
    for kind, items in runs.items():
        if not items:
            continue
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(r[k] for r in items) for k in items[0]}
    print(json.dumps({"summary": summary, "seeds": len(seeds),
                      "control_seeds": len(cseeds),
                      "seconds": time.perf_counter() - T_START}), flush=True)


if __name__ == "__main__":
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") not in (HERE, ROOT)]
    main()
