"""The plain reference against the program's CPU path at the cells'
test sizes, in float32: the same weights (the benchmark's, through the
program's loading path), the same inputs, the same numbers."""

import pytest
import torch

from portbench import load, tiny
from portbench.reference import weights as ref_weights
from portbench.reference.decoder import Decoder


@pytest.mark.parametrize("length", [1, 16, 23])
def test_logits_equal_the_programs(length):
    _, conf, _ = tiny.confs("float32")["phi4-serve-chat"]
    arch, dev = conf["arch"], torch.device("cpu")
    model = load.build_model(conf, 5, dev)
    ref = Decoder(arch, ref_weights.make_all(arch, 5, dev, torch.float32))
    g = torch.Generator().manual_seed(length)
    tokens = torch.randint(0, arch["vocab_size"], (1, length), generator=g)
    logits, _ = model.prefill_sp({"tokens": tokens.to(torch.int32)})
    want = ref.logits(tokens[0])[-1]
    assert torch.allclose(logits[0], want, rtol=1e-4, atol=1e-5)


def test_the_padding_heads_are_zero_and_the_published_ones_placed():
    _, conf, _ = tiny.confs("float32")["phi4-serve-chat"]
    arch, dev = conf["arch"], torch.device("cpu")
    model = load.build_model(conf, 5, dev)
    wq = model.flat["layers/w_q"].detach()
    hd = arch["head_dim"]
    assert wq.shape[-1] == 8 * hd          # 6 heads padded to 8
    cols = load.head_columns(arch, model, dev)
    pad = torch.ones(wq.shape[-1], dtype=torch.bool)
    pad[cols] = False
    assert torch.count_nonzero(wq[..., pad]) == 0
    assert torch.equal(wq[..., cols],
                       ref_weights.make_leaf(arch, 5, "layers/w_q", dev))
    # published head 4 (kv group 1, place 1) is the program's head 5
    assert torch.equal(cols.view(6, hd)[4], torch.arange(5 * hd, 6 * hd))


def test_a_served_run_equals_the_reference():
    line, _ = tiny.run("phi4-serve-chat", seed=11)
    assert line["correct"] and line["failed"] == 0
    assert line["checks"]["logit_gap"]["value"] < 1e-4
