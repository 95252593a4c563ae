"""The operation and byte counts against hand arithmetic."""

import pytest
import torch

from portbench.counts import fused_conv, peaks, unet


def small_unet_state():
    """A UNet of two down blocks (max stride 4), one decoder block, one head
    at stride 2, in the models' naming scheme: filters 4, rate 2."""
    def w(co, ci, k):
        return torch.zeros(co, ci, k, k)

    s = {}
    enc = "backbone.encoders.0.encoder_stack"
    s[f"{enc}.0.blocks.stack0_enc0_conv0.weight"] = w(4, 1, 3)
    s[f"{enc}.0.blocks.stack0_enc0_conv1.weight"] = w(4, 4, 3)
    s[f"{enc}.1.blocks.stack0_enc1_conv0.weight"] = w(8, 4, 3)
    s[f"{enc}.1.blocks.stack0_enc1_conv1.weight"] = w(8, 8, 3)
    s["backbone.middle_blocks.0.blocks.stack0_enc2_middle_expand_conv0.weight"] = w(16, 8, 3)
    s["backbone.middle_blocks.1.blocks.stack0_enc2_middle_contract_conv0.weight"] = w(16, 16, 3)
    dec = "backbone.decoders.0.decoder_stack.0.blocks.stack0_dec0_s4_to_s2"
    s[f"{dec}_refine_conv0.weight"] = w(8, 24, 3)
    s[f"{dec}_refine_conv1.weight"] = w(8, 8, 3)
    s["head_layers.0.CentroidConfmapsHead.0.weight"] = w(1, 8, 1)
    for k in list(s):
        s[k[:-len("weight")] + "bias"] = torch.zeros(s[k].shape[0])
    return s


def test_unet_forward_flops_by_hand():
    h = w = 16
    by_hand = 2 * (
        h * w * 9 * (1 * 4 + 4 * 4)            # enc0 at 16 x 16
        + (h // 2) * (w // 2) * 9 * (4 * 8 + 8 * 8)  # enc1 at 8 x 8
        + (h // 4) * (w // 4) * 9 * (8 * 16 + 16 * 16)  # middle at 4 x 4
        + (h // 2) * (w // 2) * 9 * (24 * 8 + 8 * 8)  # decoder at 8 x 8 (16 + 8 channels in)
        + (h // 2) * (w // 2) * 1 * 8 * 1)      # the 1x1 head at stride 2
    got = unet.forward_flops(small_unet_state(), (h, w), {"CentroidConfmapsHead": 2})
    assert got == by_hand


def test_unet_counts_follow_the_input_size():
    s = small_unet_state()
    small = unet.forward_flops(s, (16, 16), {"CentroidConfmapsHead": 2})
    assert unet.forward_flops(s, (32, 16), {"CentroidConfmapsHead": 2}) == 2 * small


def test_fused_conv_call_cost_by_hand():
    flops, nbytes = fused_conv.call_cost(2, 8, 8, 3, 5, 7, 2)
    assert flops == 2 * 2 * 8 * 8 * 9 * (3 * 5 + 5 * 7)
    assert nbytes == (2 * 8 * 8 * (3 + 7) + 9 * (3 * 5 + 5 * 7)) * 2 + 4 * (5 + 7)


@pytest.mark.parametrize("itemsize, peak", [(2, peaks.PEAK_BF16), (4, peaks.PEAK_F32)])
def test_fused_conv_bound_is_the_larger_of_operations_and_bytes(itemsize, peak):
    flops, nbytes = fused_conv.call_cost(8, 64, 64, 24, 24, 24, itemsize)
    want = max(flops / peak, nbytes / peaks.PEAK_BYTES)
    assert fused_conv.call_bound_s(8, 64, 64, 24, 24, 24, itemsize) == pytest.approx(want)


def test_bound_names_what_bounds_it():
    assert peaks.bound(989e12, 1.0, peaks.PEAK_BF16) == (1.0, "operations")
    assert peaks.bound(1.0, 3.35e12, peaks.PEAK_BF16) == (1.0, "bytes")


def test_span_names_round_trip():
    name = fused_conv.span_name(8, 1024, 1024, 1, 24, 24, 2)
    assert fused_conv.parse_span(name) == (8, 1024, 1024, 1, 24, 24, 2)
    assert fused_conv.parse_span("portbench.enqueue") is None
