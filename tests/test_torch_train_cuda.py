"""On the card: the three autograd forms with their kernels. Each forward
(the kernel) agrees with the XLA twin within the kernels' bf16 rule, its
gradients are the twin's own (autograd through the twin on the same
inputs), and the backward launches no kernel; the raw wrappers raise for an
input that requires a gradient and launch under ``torch.no_grad()``. No
JAX here: the card's machine has none, and these tests hold the kernels
against the port's own twins. Skipped without a CUDA card."""

import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
    fused_attention_block as tfab,
)

KERNEL_ATOL = KERNEL_RTOL = 8e-3   # one bf16 ulp of outputs below 2


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale) \
        .bfloat16()


def route_check(kernel, wrapper, vjp_fn, twin, inputs, grad_index,
                vjp_name):
    """``vjp_fn(*inputs)`` (those at grad_index requiring grad) against
    ``twin(*inputs)``: forward within the bf16 rule, gradients of the twin's
    autograd, no launch of ``kernel`` in the backward; ``wrapper(*inputs)``
    raises naming ``vjp_name`` and launches under no_grad."""
    def leaves():
        return [t.detach().requires_grad_(i in grad_index)
                if torch.is_tensor(t) else t for i, t in enumerate(inputs)]

    got_in = leaves()
    before = kernel.launches
    out = vjp_fn(*got_in)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    d_out = torch.randn(out.shape, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(1)).to(out.dtype)
    out.backward(d_out)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1, "the backward launched a kernel"
    want_in = leaves()
    want = twin(*want_in)
    torch.testing.assert_close(out.float(), want.detach().float(),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    want.backward(d_out)
    for i in grad_index:
        torch.testing.assert_close(got_in[i].grad, want_in[i].grad,
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match=vjp_name):
        wrapper(*got_in)
    with torch.no_grad():
        wrapper(*got_in)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2


@pytest.mark.gpu
def test_cuda_attention_core_vjp():
    """T0-3B's heads on the training encoder's 10 prefix positions, a
    masked key."""
    gen = cuda_or_skip()
    q, k, v = (randn(gen, 4, 10, 32 * 64) for _ in range(3))
    bias = torch.randn((32, 10, 10), generator=gen, device="cuda")
    mask = torch.ones((4, 10), dtype=torch.int32, device="cuda")
    mask[1, -3:] = 0
    route_check(tfab.t5_attention_core,
                lambda *t: tfab.t5_attention_core(*t, 32),
                lambda *t: tfab.t5_attention_core_vjp(*t, 32),
                lambda *t: tfab._t5_attention_reference(*t, 32),
                [q, k, v, bias, mask], (0, 1, 2), "t5_attention_core_vjp")


@pytest.mark.gpu
@pytest.mark.parametrize("gated", [True, False])
def test_cuda_t5_ffn_vjp(gated):
    gen = cuda_or_skip()
    d, f = 512, 1280
    x = randn(gen, 4, 10, d)
    lnw = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
    wi_0 = randn(gen, d, f, scale=d ** -0.5)
    wi_1 = randn(gen, d, f, scale=d ** -0.5) if gated else None
    wo = randn(gen, f, d, scale=f ** -0.5)
    route_check(tfab.fused_t5_ffn, tfab.fused_t5_ffn, tfab.fused_t5_ffn_vjp,
                tfab._t5_ffn_reference, [x, lnw, wi_0, wi_1, wo], (0,),
                "fused_t5_ffn_vjp")


@pytest.mark.gpu
def test_cuda_gpt2_block_vjp():
    """GPT-2 small's widths at ClipCap's 42 training positions."""
    gen = cuda_or_skip()
    d, f = 768, 3072
    vec = [randn(gen, d, scale=0.1) for _ in range(6)]
    params = [vec[0] + 1, vec[1], randn(gen, d, 3 * d, scale=0.02),
              randn(gen, 3 * d, scale=0.1), randn(gen, d, d, scale=0.02),
              vec[2], vec[3] + 1, vec[4], randn(gen, d, f, scale=0.02),
              randn(gen, f, scale=0.1), randn(gen, f, d, scale=0.02), vec[5]]
    x = randn(gen, 8, 42, d)
    mask = torch.ones((8, 42), dtype=torch.int32, device="cuda")
    route_check(tfab.fused_gpt2_block,
                lambda *t: tfab.fused_gpt2_block(*t, num_heads=12),
                lambda *t: tfab.fused_gpt2_block_vjp(*t, 12),
                lambda *t: tfab._gpt2_block_reference(*t, 12, 1e-5),
                [x, mask, *params], (0,), "fused_gpt2_block_vjp")
