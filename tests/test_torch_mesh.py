"""The port's mesh launcher (train/mesh.py and `train(mesh=...)`):
`parse_mesh` against the JAX function, the refusals of the expert- and
context-parallel specs, and `--mesh dp=2`, `fsdp=2` and a dp=2 -> fsdp=2
resume end to end through `train/loop.train` on gloo CPU ranks
(tests/torch_dist_worker.py)."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

from vitrs_tpu.train import mesh as JMS
from vitrs_tpu_torch import checkpoint as TCK
from vitrs_tpu_torch.config import get_config
from vitrs_tpu_torch.train import loop as TL
from vitrs_tpu_torch.train import mesh as TMS
from test_torch_helpers import assert_params_close, spawn_ranks

# tests/test_mesh_cli.py's specs
SPECS = ["dp=2,tp=2,pp=2", "dp=2,tp=2,sp", "tp=4,vp",
         "pp=2,schedule=1f1b-interleaved,v=2,mb=8", "fsdp=8", "ep=2,tp=2",
         "dp=4,tp=2", "tp=2,vp", "dp=2,pp=2,schedule=1f1b", "cp=2",
         "pp=2,schedule=1f1b-interleaved,v=1,mb=4", "dp=2,fsdp=4", "dp=4"]
OVR = {"num_layers": 2, "num_heads": 2, "channels": 128, "vocab_size": 97,
       "max_seq_len": 32}
CFG = get_config("gpt-nano").replace(**OVR)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_mesh_matches_jax(spec):
    got, want = TMS.parse_mesh(spec), JMS.parse_mesh(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.n_devices, got.describe()) == (want.n_devices,
                                               want.describe())


def test_parse_mesh_refuses_what_jax_refuses():
    for bad in ("zz=3", "dp=2,q"):
        with pytest.raises(ValueError):
            JMS.parse_mesh(bad)
        with pytest.raises(ValueError):
            TMS.parse_mesh(bad)


def test_pure_dp_spec_returns_none():
    cfg = get_config("gpt-nano")
    assert TMS.make_plan(cfg, TMS.parse_mesh("dp=4"), device="cpu") is None


MOE_OVR = {"num_experts": 4}
# the TrainConfig fields, the error and its words of each spec's refusal:
# the JAX plan's own (ep on a dense config, ep x tp with the knobs, cp with
# Muon) or a one-process run of a multi-rank spec
REFUSALS = {
    "ep=2": ({}, ValueError, "needs a MoE config"),
    "cp=2": ({}, RuntimeError, "one process a rank"),
    "ep=2,tp=2": (dict(clip_norm=1.0, model_overrides=MOE_OVR), ValueError,
                  "wired for dp x ep"),
    "dp=2,cp=2": (dict(optimizer="muon"), ValueError, "AdamW"),
    "dp=2,ep=2": (dict(model_overrides=MOE_OVR), RuntimeError,
                  "one process a rank"),
}


@pytest.mark.parametrize("spec", ["ep=2", "cp=2", "ep=2,tp=2",
                                  "dp=2,cp=2", "dp=2,ep=2"])
def test_unported_families_raise_naming_item_18(spec, tmp_path):
    """Expert and context parallelism are ported: each spec pins one of
    their refusals through `train` (REFUSALS)."""
    fields, err, words = REFUSALS[spec]
    tc = TL.TrainConfig(preset="gpt-nano", steps=1, device="cpu",
                        workdir=str(tmp_path), mesh=spec, **fields)
    with pytest.raises(err, match=words):
        TL.train(tc)


def test_dp_mesh_needs_its_world():
    tc = TL.TrainConfig(preset="gpt-nano", steps=1, device="cpu",
                        mesh="dp=2")
    with pytest.raises(ValueError, match="torchrun"):
        TL.train(tc)


def _tc(workdir, mesh, **kw):
    base = dict(preset="gpt-nano", dataset="synthetic", steps=6,
                batch_size=8, lr=1e-2, warmup=2, weight_decay=0.0,
                dtype="float32", workdir=workdir, log_every=1, ckpt_every=0,
                mesh=mesh, device="cpu", prefetch=0, model_overrides=OVR)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """dp=2 and fsdp=2 straight for 6 steps; dp=2 for 3 steps, then fsdp=2
    resumes its checkpoint to step 6."""
    out = {}
    for name, world, parts in (
            ("dp", 2, [("dp=2", {})]),
            ("fsdp", 2, [("fsdp=2", {})]),
            ("resume", 2, [("dp=2", dict(run_steps=3, ckpt_every=3)),
                           ("fsdp=2", dict(ckpt_every=3))])):
        d = tmp_path_factory.mktemp(name)
        wd = str(d / "work")
        for i, (mesh, kw) in enumerate(parts):
            spawn_ranks("train", world, d / f"part{i}",
                        {"preset": "gpt-nano", "tc": _tc(wd, mesh, **kw)})
        out[name] = wd
    return out


def _losses(wd):
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


def _last(wd):
    return TCK.load_checkpoint(sorted(glob.glob(wd + "/ckpt_*.bin"))[-1])


@pytest.mark.parametrize("name", ["dp", "fsdp"])
def test_mesh_trains_end_to_end_on_cpu_ranks(runs, name):
    losses = _losses(runs[name])
    assert len(losses) == 6 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    params, _, extras = _last(runs[name])
    assert extras["step"] == 6
    if name == "fsdp":
        assert glob.glob(runs[name] + "/meshopt_*.tree")


def test_dp_and_fsdp_take_the_same_steps(runs):
    """Both compute the global-mean gradient and AdamW from it: the same
    losses and parameters up to the order of the sums."""
    np.testing.assert_allclose(_losses(runs["fsdp"]), _losses(runs["dp"]),
                               rtol=1e-5)
    assert_params_close(_last(runs["fsdp"])[0], _last(runs["dp"])[0],
                        CFG, rtol=2e-3, atol=1e-4)


def test_resume_from_dp_into_fsdp(runs):
    """A dp=2 checkpoint resumes under fsdp=2 (its AdamW m and v with it)
    and ends where the straight dp=2 run ends, as tests/test_mesh_cli.py's
    mesh-change resume does."""
    p, _, e = _last(runs["resume"])
    assert e["step"] == 6
    assert len(_losses(runs["resume"])) == 6
    assert_params_close(p, _last(runs["dp"])[0], CFG, rtol=2e-3, atol=1e-4)
