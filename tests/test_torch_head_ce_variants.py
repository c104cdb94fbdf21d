"""PyTorch port: the variant harness of K8 (vitrs_tpu_torch/utils/
head_ce_variants.py) stays in step with csrc/fused_head_ce.cu: every edit of
every variant finds its text in the source, so the harness builds each
variant on the card instead of reporting that an edit does not apply."""

import pytest

from vitrs_tpu_torch.utils import head_ce_variants


@pytest.mark.parametrize("name", sorted(head_ce_variants.VARIANTS))
def test_variant_edits_apply(name):
    with open(head_ce_variants.SRC) as f:
        src = f.read()
    for old, new in head_ce_variants.VARIANTS[name]:
        assert old in src, old[:60]
        assert new != old
