"""The bf16 actor-critic heads on the card against their CPU result.

Marked `gpu`: the test decides inside itself whether a CUDA device is
present and skips otherwise (the CPU parity with the JAX package is
tests/test_torch_mixed_precision.py's). Run on a GPU machine with

    python -m pytest --noconftest -m gpu tests/test_torch_mixed_precision_gpu.py

At go1_mob's widths (history 2100, 512-256-128 towers, 256-128
adaptation) with seeded weights and inputs: the action mean, the latent,
the value and `actor_critic_heads` within 1e-2 of the CPU's (cuBLAS and
the CPU's bf16 products accumulate in fp32 in different orders, so a
hidden activation can round to the neighbouring bf16 value), the tower
outputs fp32 on both.
"""
import pytest
import torch

from wtw_tpu_torch.models import actor_critic as ac

pytestmark = pytest.mark.gpu


def test_bf16_heads_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the bf16 products on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    O, P, H, A = 70, 2, 2100, 12
    gen = torch.Generator().manual_seed(0)
    model = ac.ActorCritic(O, P, H, A, ac.ACArgs(compute_dtype="bfloat16"),
                           generator=gen)
    oh, lat, pr = (torch.randn(256, n, generator=gen) for n in (H, P, P))

    def heads(m, *xs):
        with torch.no_grad():
            return [m.distribution(xs[0])[0], m.adaptation_module(xs[0]),
                    m.evaluate(xs[0], xs[2]),
                    *m.actor_critic_heads(*xs)]

    want = heads(model, oh, lat, pr)
    got = heads(model.to("cuda"), *(x.cuda() for x in (oh, lat, pr)))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-2)
