"""PyTorch port: the variant harness of K2/K3-bwd (vitrs_tpu_torch/utils/
bwd_variants.py) stays in step with csrc/flash_bwd.cu: every edit of every
variant finds its text in the source, so the harness builds each variant
on the card instead of reporting that an edit does not apply."""

import pytest

from vitrs_tpu_torch.utils import bwd_variants


@pytest.mark.parametrize("name", sorted(bwd_variants.VARIANTS))
def test_variant_edits_apply(name):
    with open(bwd_variants.SRC) as f:
        src = f.read()
    for old, new in bwd_variants.VARIANTS[name]:
        assert old in src, old[:60]
        assert new != old
