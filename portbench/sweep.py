"""The knee of an open-loop prefill cell: the same engine, warmed once,
offered the cell's traffic at each of `--rates` in turn for `--seconds`
each.  The knee is the highest rate at which completions keep pace with
arrivals: the backlog (due but unserved) when the window closes is no
larger than the slot count.  The cell's rate is then 0.8 x the knee,
written into its workload file as a number.

    python3 portbench/sweep.py --workload gpt2-124m.prefill \\
        --rates 200,400,600,800 --seconds 10 --seed 5

Prints one JSON line a rate.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="gpt2-124m.prefill")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    import numpy as np
    from portbench import harness, weights as W
    from portbench.shape import Shape
    from portbench.spec import Spec
    from portbench.tracing import Tracer
    from portbench.traffic import prefill as PF
    spec = Spec()
    wl = spec.workload(args.workload)
    conf = spec.config(wl["config"])
    s = Shape.from_config(conf)
    cfg = harness.program_config(conf, s)
    p = wl["params"]
    eng = PF.program_engine(cfg, W.make_weights(s, args.seed, "cuda"), p,
                            args.seed)
    PF._warm(eng, p, np.random.default_rng(args.seed), s.vocab_size)
    for rate in (float(x) for x in args.rates.split(",")):
        q = dict(p, rate=rate)
        due, lens, prompts = PF.schedule(q, args.seconds, args.seed,
                                         s.vocab_size)
        passes0 = eng.prefill_dispatches
        r = PF.serve(eng, due, prompts, args.seconds, 20.0,
                     Tracer(False, True))
        done = ~np.isnan(r["done_t"])
        ttft = (np.where(done, r["done_t"], r["window_s"]) - due) * 1e3
        in_window = int(np.sum(r["done_t"] <= args.seconds))
        print(json.dumps({
            "rate": rate, "requests": len(due), "served": int(done.sum()),
            "served_in_window_per_s": in_window / args.seconds,
            "backlog_at_end": r["backlog_end"],
            "keeps_pace": r["backlog_end"] <= p["slots"],
            "ttft_p50_ms": float(np.median(ttft)),
            "ttft_p95_ms": PF.p95(ttft), "window_s": r["window_s"],
            "prefill_passes": eng.prefill_dispatches - passes0,
            "prompt_tokens": int(lens.sum())}), flush=True)


if __name__ == "__main__":
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") not in (HERE, ROOT)]
    main()
