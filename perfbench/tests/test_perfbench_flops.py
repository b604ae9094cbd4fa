"""The FLOP and byte counts against hand counts at the cells' shapes."""

import pytest

from perfbench import cells, flops


def sizes(name):
    return cells.cell(name).sizes


def test_dense_7b_8l_train_step():
    s = sizes("dsllm7b-8l.train-4k")
    # 8 layers of 4 x 4096^2 + 3 x 4096 x 11008 + two norms, the head
    # (4096 x 102400) and the final norm; the embedding left out
    per_layer = 4 * 4096 ** 2 + 3 * 4096 * 11008 + 2 * 4096
    active = 8 * per_layer + 4096 * 102400 + 4096
    assert flops.active_params(s) == active == 2_038_501_376
    b, t = 2, 4096
    attn = 8 * 4.0 * b * 32 * t * t * 128 / 2
    assert flops.train_flops(s, b, t) == 6.0 * active * b * t + 3 * attn
    assert flops.train_flops(s, b, t) == pytest.approx(106.8e12, rel=1e-3)


def test_dense_7b_serve_forward():
    s = sizes("dsllm7b.serve-2k")
    per_layer = 4 * 4096 ** 2 + 3 * 4096 * 11008 + 2 * 4096
    active = 30 * per_layer + 4096 * 102400 + 4096
    assert flops.active_params(s) == active == 6_490_935_296
    got = flops.forward_flops(s, 8, 2048)
    assert got == pytest.approx(2 * active * 8 * 2048
                                + 30 * 4.0 * 8 * 32 * 2048 ** 2 * 128 / 2)
    assert got == pytest.approx(221.0e12, rel=2e-3)


def test_dense_7b_full_depth_fsdp4_step():
    # the four-chip cell's shapes (30 layers, one 4096 sequence a rank)
    s = cells.Sizes(vocab=102400, d_model=4096, n_layers=30, n_heads=32,
                    d_ff=11008, max_seq=4096, dtype="bfloat16", eps=1e-6,
                    rope_theta=1e4)
    assert flops.train_flops(s, 4, 4096) == pytest.approx(687.6e12,
                                                          rel=1e-3)


def test_flash_costs_by_hand():
    b, t, h, d = 2, 4096, 32, 128
    scores = b * h * t * (t + 1) / 2
    tile = b * t * h * d * 2
    rows = b * h * t * 4
    assert flops.flash_costs("flash_fwd", b, t, h, d) == (
        4 * d * scores, 4 * tile + rows)
    assert flops.flash_costs("flash_bwd_dq", b, t, h, d) == (
        2 * d * scores + 2 * b * h * t * d, 6 * tile + 2 * rows)
    assert flops.flash_costs("flash_bwd_dkv", b, t, h, d) == (
        8 * d * scores, 6 * tile + 2 * rows)
    with pytest.raises(ValueError):
        flops.flash_costs("flash_other", b, t, h, d)


def test_the_backward_counts_five_products_once():
    # S, dP, dV, dK, dQ: 2.5 x the forward's two, whatever the split
    b, t, h, d = 3, 4096, 32, 128
    fwd = flops.flash_costs("flash_fwd", b, t, h, d)[0]
    bwd = sum(flops.flash_costs(k, b, t, h, d)[0]
              for k in ("flash_bwd_dq", "flash_bwd_dkv"))
    assert bwd == pytest.approx(2.5 * fwd, rel=1e-3)


def test_bound_names_its_side():
    assert flops.bound(989e12, 1.0, 989e12, 3.35e12) == (1.0, "operations")
    assert flops.bound(1.0, 3.35e12, 989e12, 3.35e12) == (1.0, "bytes")
    # the forward at the training shape is bound by its operations
    fl, nb = flops.flash_costs("flash_fwd", 2, 4096, 32, 128)
    assert flops.bound(fl, nb, 989e12, 3.35e12)[1] == "operations"


@pytest.mark.parametrize("name, group", [
    ("flash_fwd_bf16_kernel", "flash_fwd"),
    ("flash_bwd_dq_bf16_kernel", "flash_bwd_dq"),
    ("flash_bwd_dkv_simt_kernel", "flash_bwd_dkv"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64", "matmul"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
])
def test_kernel_group(name, group):
    assert flops.kernel_group(name) == group


def _flash_costs_before(kernel, b, t, h, d, elem=2):
    """`flash_costs` as it was with one head dim and as many key/value
    heads as query heads."""
    scores = b * h * t * (t + 1) / 2
    tile = b * t * h * d * elem
    rows = b * h * t * 4
    if kernel == "flash_fwd":
        return 2 * 2.0 * d * scores, 3 * tile + tile + rows
    if kernel == "flash_bwd_dq":
        return 1 * 2.0 * d * scores + 2.0 * b * h * t * d, \
            5 * tile + rows + tile + rows
    return 4 * 2.0 * d * scores, 4 * tile + 2 * rows + 2 * tile


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"])
@pytest.mark.parametrize("shape", [(3, 4096, 32, 128), (32, 2048, 32, 128),
                                   (1, 4096, 32, 128), (1, 256, 2, 128),
                                   (8, 2048, 16, 64), (2, 1000, 7, 96),
                                   (5, 8191, 40, 256)])
@pytest.mark.parametrize("elem", [2, 4])
def test_flash_costs_at_the_defaults_are_the_old_ones_bit_for_bit(
        kernel, shape, elem):
    new = flops.flash_costs(kernel, *shape, elem)
    old = _flash_costs_before(kernel, *shape, elem)
    assert new == old
    assert [type(x) for x in new] == [type(x) for x in old]
    assert flops.flash_costs(kernel, *shape, elem, shape[3], shape[2]) == old


def test_flash_costs_with_split_head_dims_by_hand():
    # MLA with no q-LoRA: 16 heads, q/k 128 + 64 rope = 192, v 128
    b, t, h, d, dv, hkv = 2, 8192, 16, 192, 128, 16
    scores = b * h * t * (t + 1) / 2
    q, o = b * t * h * d * 2, b * t * h * dv * 2
    k, v = b * t * hkv * d * 2, b * t * hkv * dv * 2
    rows = b * h * t * 4
    fwd = flops.flash_costs("flash_fwd", b, t, h, d, 2, dv, hkv)
    assert fwd == (2 * 192 * scores + 2 * 128 * scores,
                   q + k + v + o + rows)
    dq = flops.flash_costs("flash_bwd_dq", b, t, h, d, 2, dv, hkv)
    assert dq == (2 * 192 * scores + 2 * b * h * t * 128,
                  q + k + v + 2 * o + q + 2 * rows)
    dkv = flops.flash_costs("flash_bwd_dkv", b, t, h, d, 2, dv, hkv)
    assert dkv == (2 * 2 * 192 * scores + 2 * 2 * 128 * scores,
                   q + k + v + o + 2 * rows + k + v)
    # the padded path would be charged 192 for v too
    padded = flops.flash_costs("flash_fwd", b, t, h, d)
    assert padded[0] > fwd[0] and padded[1] > fwd[1]


def test_grouped_kv_heads_read_fewer_k_v_bytes():
    b, t, h, d = 1, 4096, 32, 128
    whole = flops.flash_costs("flash_fwd", b, t, h, d)
    grouped = flops.flash_costs("flash_fwd", b, t, h, d, 2, d, 8)
    assert grouped[0] == whole[0]
    assert whole[1] - grouped[1] == 2 * b * t * (h - 8) * d * 2
