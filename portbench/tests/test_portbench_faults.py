"""The comparison that decides `correct` fails what it must, on the CPU at
small sizes, under the cells' own limits.

- The control: what computes below the configuration's precision.  For
  the training cells the reference with fp8 (e4m3) operands held to the
  fp32 reference; for the serving and inference cells the program's own
  int8 paths (the engine on int8 weights; the w8a8 forward), driven
  through the whole run as `calibrate.py` drives them on the chip.
- Faults planted underneath the harness, in the program, with the rest
  of a run as it is: a step that returns its state unchanged; half of the
  batch left out, the mean taken over the rest; a token or an answer
  altered where it is produced; a cache the prefill never writes; a bias
  add dropped, or two layers' LayerNorm gains swapped, in the weights the
  program's forward reads.
"""

import numpy as np
import pytest
import torch

from portbench import calibrate, harness
from portbench.reference import compare
from portbench.tests.tiny import tiny_spec, write

SEED = 2**31 + 4242
# GPT-2's widths and depth in bf16, at 128 positions: int8's share of K
# and V values off by more than 4% of their rms matches the chip's here
# (about 1% against bf16's 0.01%), where tiny widths in fp32 show none
FULL_WIDTH_GPT = {
    "preset": "gpt2-124m", "dtype": "bfloat16",
    "overrides": {"max_seq_len": 128},
    "shape": {"mode": "gpt", "num_layers": 12, "channels": 768,
              "num_heads": 12, "max_seq_len": 128, "vocab_size": 50257,
              "mlp_ratio": 4, "act": "gelu_tanh", "ln_eps": 1e-05}}
# ViT-B/16's widths and depth in bf16, on 64 x 64 images (17 tokens):
# w8a8's share of logits off by more than 4% of their rms matches the
# chip's here (about 18% against bf16's 0.3%); at tiny widths in fp32 the
# two read alike
FULL_WIDTH_VIT = {
    "preset": "vit-b-16", "dtype": "bfloat16",
    "overrides": {"act": "gelu_erf", "img_size": 64, "max_seq_len": 17},
    "shape": {"mode": "vit", "num_layers": 12, "channels": 768,
              "num_heads": 12, "max_seq_len": 17, "mlp_ratio": 4,
              "act": "gelu_erf", "ln_eps": 1e-05, "img_size": 64,
              "patch_size": 16, "in_chans": 3, "num_classes": 1000}}
# a size at which fp8 rounding is not drowned by the tiny widths' own
# arithmetic: 2 layers of 128, 4 heads, 64 positions
SMALL_GPT = {"preset": "gpt-nano", "dtype": "float32",
             "overrides": {"num_layers": 2, "channels": 128, "num_heads": 4,
                           "max_seq_len": 64, "vocab_size": 512},
             "shape": {"mode": "gpt", "num_layers": 2, "channels": 128,
                       "num_heads": 4, "max_seq_len": 64, "vocab_size": 512,
                       "mlp_ratio": 4, "act": "gelu_tanh", "ln_eps": 1e-05}}


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_spec(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="module")
def small_spec(tmp_path_factory):
    torch.set_num_threads(2)
    spec = tiny_spec(tmp_path_factory.mktemp("small"))
    conf = spec.config("gpt2-124m")
    conf.update(SMALL_GPT)
    write(conf, f"{spec.root}/configs/gpt2-124m.json")
    wl = spec.workload("gpt2-124m.train")
    wl["params"].update({"batch": 8, "ref_block": 4})
    write(wl, f"{spec.root}/workloads/gpt2-124m.train.json")
    return spec


@pytest.fixture(scope="module")
def full_width_spec(tmp_path_factory):
    torch.set_num_threads(4)
    spec = tiny_spec(tmp_path_factory.mktemp("full"))
    conf = spec.config("gpt2-124m")
    conf.update(FULL_WIDTH_GPT)
    write(conf, f"{spec.root}/configs/gpt2-124m.json")
    wl = spec.workload("gpt2-124m.prefill")
    wl["params"].update({"max_len": 128, "buckets": [64, 128],
                         "median_prompt": 64, "min_prompt": 8,
                         "max_prompt": 127, "rate": 20.0, "slots": 4,
                         "check_requests": 6})
    write(wl, f"{spec.root}/workloads/gpt2-124m.prefill.json")
    return spec


@pytest.fixture(scope="module")
def full_width_vit_spec(tmp_path_factory):
    torch.set_num_threads(4)
    spec = tiny_spec(tmp_path_factory.mktemp("full_vit"))
    conf = spec.config("vit-b-16")
    conf.update(FULL_WIDTH_VIT)
    write(conf, f"{spec.root}/configs/vit-b-16.json")
    wl = spec.workload("vit-b-16.infer")
    wl["params"].update({"batch": 4, "ref_block": 4})
    write(wl, f"{spec.root}/workloads/vit-b-16.infer.json")
    return spec


def run(spec, cell, seed=SEED, seconds=0.3):
    return harness.run_cell(cell, seed, seconds, False, 0.0, "cpu", spec)


def failed(line):
    return [k for k, (v, lim) in line["checks"].items()
            if not (v is not None and v <= lim)]


# -- the control -----------------------------------------------------------

@pytest.mark.parametrize("cell", ["gpt2-124m.train", "vit-b-16.train"])
def test_training_control_fp8_reference_fails(small_spec, cell, monkeypatch):
    """The reference in fp8 against the reference in fp32: as calibrate.py
    reads it on the chip."""
    import portbench.spec as SP
    monkeypatch.setattr(SP, "ROOT", small_spec.root)
    numbers = calibrate.train_control(cell, SEED, device="cpu")
    limits = small_spec.workload(cell)["limits"]
    checks = compare.check(numbers, limits)
    assert not all(c["ok"] for c in checks.values()), checks


def test_prefill_sound_at_full_width_passes(full_width_spec):
    line = run(full_width_spec, "gpt2-124m.prefill", seconds=0.5)
    assert line["correct"] is True, line["checks"]


def test_prefill_control_int8_engine_fails(full_width_spec, monkeypatch):
    from portbench.traffic import prefill
    monkeypatch.setattr(prefill, "program_engine",
                        calibrate.int8_engine(prefill.program_engine))
    line = run(full_width_spec, "gpt2-124m.prefill", seconds=0.5)
    assert line["correct"] is False and "kv_over" in failed(line), \
        line["checks"]


def test_infer_sound_at_full_width_passes(full_width_vit_spec):
    line = run(full_width_vit_spec, "vit-b-16.infer")
    assert line["correct"] is True, line["checks"]


def test_infer_control_w8a8_fails(full_width_vit_spec, monkeypatch):
    from portbench.traffic import offline
    monkeypatch.setattr(offline, "program_forward", calibrate.w8a8_forward)
    line = run(full_width_vit_spec, "vit-b-16.infer")
    assert line["correct"] is False and failed(line), line["checks"]


# -- faults underneath the harness -----------------------------------------

def _unchanged_state_step(cfg, mesh, **kw):
    from vitrs_tpu_torch.models import model as M
    from vitrs_tpu_torch.parallel import data_parallel as dp

    def step(params, m, v, x, y, t, lr, wd):
        xb, yb = dp._batch_on(x, y, mesh.device, cfg, kw.get("normalize"))
        with torch.no_grad():
            loss = M.loss_fn(params, xb, yb, cfg)
        return params, m, v, loss
    return step


@pytest.mark.parametrize("cell", ["gpt2-124m.train", "vit-b-16.train"])
def test_training_step_returning_its_state_unchanged_fails(spec, cell,
                                                           monkeypatch):
    from vitrs_tpu_torch.parallel import data_parallel as dp
    monkeypatch.setattr(dp, "make_dp_train_step", _unchanged_state_step)
    line = run(spec, cell)
    assert line["correct"] is False
    assert "change_gap" in failed(line)
    assert line["checks"]["change_gap"][0] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["gpt2-124m.train", "vit-b-16.train"])
def test_training_half_batch_fails(small_spec, cell, monkeypatch):
    from vitrs_tpu_torch.parallel import data_parallel as dp
    monkeypatch.setattr(dp, "make_dp_train_step",
                        calibrate.half_batch_step(dp.make_dp_train_step))
    line = run(small_spec, cell)
    assert line["correct"] is False and failed(line), line["checks"]


def test_prefill_altered_token_fails(full_width_spec, monkeypatch):
    """At GPT-2's widths: the next id lies logits below the best there (3.4
    and more on the chip), where 16 channels spread the logits too little
    to tell it from rounding."""
    from vitrs_tpu_torch.serving_gen import GenerationEngine
    monkeypatch.setattr(GenerationEngine, "_sample_host",
                        calibrate.altered_token(
                            GenerationEngine._sample_host))
    line = run(full_width_spec, "gpt2-124m.prefill", seconds=0.5)
    assert line["correct"] is False and "token_gap" in failed(line)


def test_prefill_cache_never_written_fails(spec, monkeypatch):
    from vitrs_tpu_torch.models import generate as G

    def unwritten(params, prompts, caches, slots, cfg):
        return None, caches
    monkeypatch.setattr(G, "prefill_into_slots", unwritten)
    line = run(spec, "gpt2-124m.prefill")
    assert line["correct"] is False and "kv_over" in failed(line)


@pytest.mark.parametrize("how", ["one answer replaced", "answers swapped"])
def test_infer_altered_answer_fails(spec, monkeypatch, how):
    from vitrs_tpu_torch.models import model as M
    real = M.vit_forward

    def altered(*a, **k):
        out = real(*a, **k).clone()
        if how == "one answer replaced":
            out[0] = out[1]
        else:
            out = out.roll(1, dims=0)
        return out
    monkeypatch.setattr(M, "vit_forward", altered)
    line = run(spec, "vit-b-16.infer")
    assert line["correct"] is False and failed(line), line["checks"]


def test_infer_half_batch_fails(spec, monkeypatch):
    from vitrs_tpu_torch.models import model as M
    real = M.vit_forward

    def half(params, images, cfg, *a, **k):
        n = images.shape[0] // 2
        out = real(params, images[:n], cfg, *a, **k)
        return torch.cat([out, out])
    monkeypatch.setattr(M, "vit_forward", half)
    line = run(spec, "vit-b-16.infer")
    assert line["correct"] is False and "row_over" in failed(line)


@pytest.mark.parametrize("fault", calibrate.WEIGHT_FAULTS)
@pytest.mark.parametrize("cell", ["gpt2-124m.train", "vit-b-16.train",
                                  "gpt2-124m.prefill", "vit-b-16.infer"])
def test_weight_fault_in_the_forward_fails(spec, cell, fault, monkeypatch):
    """The weights are drawn with the spread of trained affine parameters,
    so a bias add the program drops, or a LayerNorm gain it takes from
    another layer, shows in every cell's comparison."""
    from vitrs_tpu_torch.models import model as M
    for name in ("prepare_params", "train_params"):
        monkeypatch.setattr(M, name,
                            calibrate.planted(fault, getattr(M, name)))
    line = run(spec, cell)
    assert line["correct"] is False and failed(line), line["checks"]


def test_sound_runs_pass_on_several_seeds(spec):
    """The same comparison passes the program as it is (fp32 here)."""
    rng = np.random.default_rng(0)
    for seed in rng.integers(0, 2**40, size=2):
        for cell in ("gpt2-124m.train", "vit-b-16.infer"):
            assert run(spec, cell, int(seed))["correct"] is True
