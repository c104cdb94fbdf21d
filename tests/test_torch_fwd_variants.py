"""PyTorch port: the variant harness of K1-fwd/K3-fwd/K4 (vitrs_tpu_torch/
utils/fwd_variants.py) stays in step with csrc/flash_fwd.cu: every edit of
every variant finds its text in the source, so the harness builds each
variant on the card instead of reporting that an edit does not apply."""

import pytest

from vitrs_tpu_torch.utils import fwd_variants


@pytest.mark.parametrize("name", sorted(fwd_variants.VARIANTS))
def test_variant_edits_apply(name):
    with open(fwd_variants.SRC) as f:
        src = f.read()
    for old, new in fwd_variants.VARIANTS[name]:
        assert old in src, old[:60]
        assert new != old
