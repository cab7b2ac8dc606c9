"""resnet_bf16_layers.py's helpers, on the CPU: the bf16 comparison of
two tensors in units in the last place, the update-norm gaps, and the
switch between the native and the rounded bf16 products (the script
itself runs the full-depth model and is run by hand on the card)."""
import numpy as np
import pytest
import torch

import resnet_bf16_layers as probe
from deeplearning4j_tpu_torch.nn.layers import base, convolution


def test_ulps_counts_differences_against_the_larger_magnitude():
    b = torch.tensor([1.0, 1.0, 2.0, 0.0, -3.0], dtype=torch.bfloat16)
    one_ulp = 2.0 ** -7
    a = torch.tensor([1.0, 1.0 + one_ulp, 2.0 + 4 * one_ulp, 1e-3, -3.0],
                     dtype=torch.bfloat16)
    differ, over = probe._ulps(a, b)
    assert differ == pytest.approx(3 / 5)
    # 1 + 2^-7 is one ulp from 1; 2 + 2^-5 is two ulps (2^-6) from 2; 1e-3
    # against 0 is all of the larger's magnitude
    assert over == pytest.approx(2 / 5)


def test_gaps_summarise_by_stage():
    ref = {"out/W": 1.0, "out/b": 2.0, "s5b1_c1/W": 1.0, "s5b1_bn1/gamma": 1.0,
           "stem_conv/W": 4.0, "s2b1_c1/W": 1.0}
    upd = {k: v * (1.1 if k.startswith("stem") else 1.01) for k, v in
           ref.items()}
    gaps = probe._gaps(upd, ref)
    assert gaps["worst"] == "stem_conv/W"
    assert gaps["max"] == pytest.approx(0.1)
    assert gaps["out"] == pytest.approx(0.01)
    assert gaps["s5_median"] == pytest.approx(0.01)
    assert gaps["stem_s2_median"] == pytest.approx(np.median([0.1, 0.01]))


def test_rounded_products_switch_in_and_out():
    saved = (base.bf16_product, convolution.bf16_product)
    with probe._Products("native"):
        assert (base.bf16_product, convolution.bf16_product) == saved
    with probe._Products("rounded"):
        assert base.bf16_product is probe._rounded
        assert convolution.bf16_product is probe._rounded
        x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
        w = torch.randn(5, 4, generator=torch.Generator().manual_seed(1))
        got = probe._rounded(torch.matmul, x.bfloat16(), w.bfloat16())
        want = (x.bfloat16().float() @ w.bfloat16().float()).bfloat16()
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert (base.bf16_product, convolution.bf16_product) == saved
