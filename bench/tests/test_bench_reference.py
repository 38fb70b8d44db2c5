"""The reference's sLSTM scan: its written-out backward against autograd
of the plain loop, and on the card its CUDA-graph replay against the eager
loop."""
import pytest
import torch

from bench.reference import lm


def _plain(xwb, r):
    B, S, d4 = xwb.shape
    h = c = n = xwb.new_zeros(B, d4 // 4)
    m = xwb.new_full((B, d4 // 4), lm.NEG)
    hs = []
    for t in range(S):
        h, c, n, m = lm.slstm_step(xwb[:, t] + lm._recurrent(h, r), c, n, m)
        hs.append(h)
    return torch.stack(hs, 1)


def _case(device, dtype, B=3, S=9, d=16, H=2, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    xwb = (torch.randn(B, S, 4 * d, generator=g, dtype=dtype) * 2).to(device)
    r = (torch.randn(H, d // H, 4 * d // H, generator=g, dtype=dtype) * 0.5).to(device)
    w = torch.randn(B, S, d, generator=g, dtype=dtype).to(device)
    return xwb.requires_grad_(), r.requires_grad_(), w


def test_the_written_backward_is_autograds():
    xwb, r, w = _case("cpu", torch.float64)
    a = _plain(xwb, r)
    ga = torch.autograd.grad((a * w).sum(), (xwb, r))
    b = lm.SLSTMScan.apply(xwb, r)
    gb = torch.autograd.grad((b * w).sum(), (xwb, r))
    assert torch.equal(a, b)
    for x, y in zip(ga, gb):
        assert torch.allclose(x, y, rtol=0, atol=1e-12)


@pytest.mark.chip
def test_the_graph_replay_is_the_eager_loop(card):
    for seed in (0, 1):  # the second call replays the graph captured by the first
        xwb, r, w = _case(card, torch.float32, B=4, S=64, d=64, H=4, seed=seed)
        a = _plain(xwb, r)
        ga = torch.autograd.grad((a * w).sum(), (xwb, r))
        b = lm.SLSTMScan.apply(xwb, r)
        gb = torch.autograd.grad((b * w).sum(), (xwb, r))
        assert torch.allclose(a, b, rtol=0, atol=1e-6)
        for x, y in zip(ga, gb):
            assert torch.allclose(x, y, rtol=1e-4, atol=1e-5)
