"""The bound that holds a flash forward's output (K1-fwd, K3-fwd, K4: one
CUDA kernel) to its plain PyTorch version: `chip_smoke.out_errors`, loaded
from the checkout's root, so that the smoke and the tests share one rule
(its docstring gives the reasoning); and the ring hops' gradient bound,
`chip_smoke.grad_errors`, with `summed_hops`, and the one-term allowance of the
head-dim checks, `bwd_term_norms`.  Imports no JAX: the card-only tests
use it on a machine without JAX."""

import importlib.util
import pathlib

_path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("chip_smoke", _path)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
out_errors = chip_smoke.out_errors
band_edge_qk = chip_smoke.band_edge_qk
grad_errors = chip_smoke.grad_errors
summed_hops = chip_smoke.summed_hops
bwd_term_norms = chip_smoke.bwd_term_norms


def assert_out_close(got, want):
    bad, err, rms = out_errors(got, want)
    assert bad == 0, (f"{bad} of {want.numel()} values beyond the bound: "
                      f"max_abs_err {err:.3e}, rms {rms:.3e}")
