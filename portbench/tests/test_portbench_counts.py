"""The work counts of ``portbench/counts.py`` against hand counts at tiny
shapes, and the encoder's against torch's FLOP counter on the plain
reference (its convolutions and dense layers are the algorithm's own)."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import common, counts
from portbench.tests import tiny


def test_conv_and_pqmf():
    assert counts.conv_flops(4, 2, 3, 10) == 2 * 4 * 2 * 3 * 10
    assert counts.pqmf_flops(64, 5) == 2 * 5 * 64


def test_attention_counts():
    # 2 queries, C = 4, 2 heads, 3 active of 5 keys, one clip, fp32.
    flops, nbytes = counts.attention_fwd_counts(2, 4, 2, 3, 5, 1, 4)
    assert flops == 4 * 2 * 4 * 3
    assert nbytes == (2 * 4 * 4) * 2 + 3 * 4 * 4 * 2 + 5 * 4 + 2 * 2 * 4
    flops, nbytes = counts.attention_bwd_counts(2, 4, 2, 3, 5, 1, 4)
    assert flops == 10 * 2 * 4 * 3
    assert nbytes == (2 * 4 * 4) * 4 + 3 * 4 * 4 * 2 + 5 * 4 * 4 * 2 + 5 * 4 + 2 * 2 * 4


def test_sccn_layer_by_hand():
    # Two vertices and one edge, C = 2: the edge's down and up products
    # (2 faces each), A_0 from down_1, two carriers at rank 0 and three at
    # rank 1, each with its mix and combine MLP.
    c = 2
    faces = 2 * (2 * 2 * 1 * c)
    same = 2 * 2 * 1 * c
    mixes = 2 * (2 * 2 * c * c) + 3 * (2 * 1 * c * c)
    combine = 2 * (2 * 2 * c * c + 2 * 2 * c) + 3 * (2 * 1 * c * c + 2 * 1 * c)
    assert counts.sccn_layer_flops((2, 1, 0, 0), c) == faces + same + mixes + combine


@pytest.mark.parametrize("workload", [tiny.TRAIN, tiny.CODEC])
def test_encoder_against_flop_counter(workload):
    _, cfg, _, _ = tiny.cell(workload)
    model = common.reference_model(torch, cfg, 3, "cpu")
    m = cfg["model"]
    x = torch.zeros(3, 1, m["num_samples"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.encoder.compute_logits(model.pqmf(x).transpose(-1, -2))
    total = model.encoder.total_simplices
    expected = 3 * counts.encoder_flops(m["num_samples"], m["num_bands"], total, model.pqmf.taps)
    assert counter.get_total_flops() == expected


def test_train_step_is_three_forwards():
    _, cfg, traffic, _ = tiny.cell(tiny.TRAIN)
    m = cfg["model"]
    sizes, taps, b, g = (6, 15, 20, 15), 31, 4, 3
    enc = counts.encoder_flops(m["num_samples"], m["num_bands"], sum(sizes), taps)
    dec = counts.decoder_flops(sizes, 15 + 20 + 15, m["num_samples"], m["num_bands"], m["sccn_hidden_dim"],
                               m["n_sccn_layers"], taps)
    loss = 2 * b * counts.spectral_loss_flops(m["num_samples"])
    assert counts.train_step_flops(cfg, sizes, b, g, taps) == pytest.approx(3 * (b * g * enc + b * dec + loss))
    # A packed rank decodes its capacity's rows, not the rank's size.
    packed = dict(cfg, model=dict(m, pack_capacities=[0, 0, 12, 5]))
    dec = counts.decoder_flops((6, 15, 12, 5), 15 + 12 + 5, m["num_samples"], m["num_bands"],
                               m["sccn_hidden_dim"], m["n_sccn_layers"], taps)
    assert counts.train_step_flops(packed, sizes, b, g, taps) == pytest.approx(3 * (b * g * enc + b * dec + loss))


def test_roofline_picks_the_larger_bound():
    t, bound = counts.roofline_seconds(989e12, 1.0, "bfloat16")
    assert (t, bound) == (1.0, "operations")
    t, bound = counts.roofline_seconds(1.0, 3.35e12, "bfloat16")
    assert (t, bound) == (1.0, "bytes")
