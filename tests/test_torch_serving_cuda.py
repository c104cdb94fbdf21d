"""PyTorch port, on the card: the rest of serving (ops/quant.py, the int8
KV cache, beam search, the paged engine, speculative decoding) on CUDA
against the same code on the CPU.

  * the int8 product (`quant.int8_matmul`, `torch._int_mm` on cuBLASLt)
    at the shapes that need padding on the card (a decode step's 8 rows,
    the GPT head's 50257 columns, K off a multiple of 8) and at a prefill's:
    the same int32 sums as the CPU, bit for bit; `linear_w8a8` on top of it
    within fp32 rounding (rtol 1e-6: the same scales, another order of
    nothing but the final products);
  * a small fp32 model (L=2, 2 heads of 64) through the paged engine and
    the dense engine on the card: the same greedy streams, K1-fwd launches
    == L x prefill groups, every page back in the pool;
  * the int8 KV cache's chunked prefill on the card: K4 over the
    dequantized cache (L launches a continuation chunk), last-position
    logits within 1e-3 of the CPU's (a value at an int8 rounding boundary
    may land one step apart from fp32 noise, which moves a logit by about
    1e-4 at this size);
  * beam search and greedy speculative decoding on the card: the CPU's
    tokens (fp32), the speculative output target-only greedy's.

These need an NVIDIA GPU with sm_90a and nvcc: each test skips without a
CUDA device (decided inside the `cuda` fixture, never at import).  They
import no JAX.  Run them on the card with
    python -m pytest tests/test_torch_serving_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from vitrs_tpu_torch import params as P
from vitrs_tpu_torch.config import get_config
from vitrs_tpu_torch.models import generate as G
from vitrs_tpu_torch.models import model as M
from vitrs_tpu_torch.models import speculative as S
from vitrs_tpu_torch.ops import flash_attention as FA
from vitrs_tpu_torch.ops import flash_prefill as FP
from vitrs_tpu_torch.ops import quant as Q
from vitrs_tpu_torch.serving_gen import GenerationEngine


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfg(**kw):
    return get_config("gpt-nano").replace(
        num_layers=2, num_heads=2, channels=128, vocab_size=97,
        max_seq_len=kw.pop("max_seq_len", 64), **kw).validate()


def _params(cfg, seed=0):
    return P.init_params(cfg, torch.Generator().manual_seed(seed))


def _on(params, cfg, dev):
    return M.prepare_params({k: v.to(dev) for k, v in params.items()}, cfg)


@pytest.mark.parametrize("M_,K,N", [(8, 768, 50257), (5, 30, 13),
                                    (300, 768, 2304)])
def test_int8_matmul_on_card_equals_cpu(cuda, M_, K, N):
    gen = torch.Generator().manual_seed(N)
    xq = torch.randint(-127, 128, (M_, K), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (N, K), generator=gen, dtype=torch.int8)
    got = Q.int8_matmul(xq.cuda(), wq.cuda())
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got.cpu(), Q.int8_matmul(xq, wq))
    x = torch.randn(M_, K, generator=gen)
    w, b = torch.randn(N, K, generator=gen), torch.randn(N, generator=gen)
    wq, s = Q.quantize_weight(w)
    want = Q.linear_w8a8(x, wq, s, b)
    got = Q.linear_w8a8(x.cuda(), wq.cuda(), s.cuda(), b.cuda()).cpu()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_paged_engine_on_card_equals_dense(cuda):
    cfg = _cfg()
    params = _params(cfg, 1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 9, 30, 17, 3)]
    kw = dict(max_slots=2, max_len=48, prompt_buckets=(16, 32),
              decode_chunk=4)
    streams = []
    for paged in (False, True):
        FA.flash_fwd_cuda.launches = 0
        eng = GenerationEngine({k: v.cuda() for k, v in params.items()}, cfg,
                               paged=paged, n_pages=6 if paged else 0, **kw)
        for p in prompts:
            eng.submit(p, max_new=6)
        streams.append(dict(eng.run()))
        assert FA.flash_fwd_cuda.launches == (cfg.num_layers
                                              * eng.prefill_dispatches)
    assert sorted(eng.free_pages) == list(range(1, 6))
    for rid in streams[0]:
        np.testing.assert_array_equal(streams[1][rid], streams[0][rid])


def test_int8_kv_chunked_prefill_on_card_runs_k4(cuda):
    cfg = _cfg(max_seq_len=512, num_kv_heads=1)
    params = _params(cfg, 2)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 256)))
    lg = {}
    for dev in ("cuda", "cpu"):
        pp = _on(params, cfg, dev)
        caches = G.init_kv_cache(cfg, 2, 512, int8=True, device=dev)
        FP.flash_prefill_cuda.launches = 0
        for off in range(0, 256, 64):
            out, caches = G.forward_with_cache(pp, toks[:, off:off + 64].to(dev),
                                               caches, off, cfg,
                                               last_only=True)
        lg[dev] = out.cpu()
        if dev == "cuda":
            assert FP.flash_prefill_cuda.launches == 3 * cfg.num_layers
    torch.testing.assert_close(lg["cuda"], lg["cpu"], rtol=0, atol=1e-3)


def test_beam_and_speculative_on_card_equal_cpu(cuda):
    cfg = _cfg()
    params = _params(cfg, 3)
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 9)))
    beams, specs = {}, {}
    for dev in ("cuda", "cpu"):
        pp = _on(params, cfg, dev)
        beams[dev] = G.generate_beam(pp, prompt.to(dev), cfg, 8,
                                     beams=3).cpu()
        specs[dev], _ = S.generate_speculative(pp, pp, prompt[:1].to(dev),
                                               cfg, cfg, 12, 3)
        greedy = G.generate(pp, prompt[:1].to(dev), cfg, 12, temperature=0.0)
        assert torch.equal(specs[dev], greedy)
    assert torch.equal(beams["cuda"], beams["cpu"])
    assert torch.equal(specs["cuda"].cpu(), specs["cpu"])
