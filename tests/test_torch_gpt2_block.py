"""The port's GPT-2 whole-block kernel (ClipCap's teacher-forced forward):
fused_gpt2_block_plain against the JAX package's Pallas fused_gpt2_block
(interpret mode on the CPU) in fp32 and bf16, with groups of 1, 2 and 4
sequences, 128 positions, a key mask and rows with no visible valid key;
gpt2_forward(fused_block=True) against JAX's; the wrapper on CPU tensors;
and the CUDA kernel against the plain version on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (
    gpt2_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import gpt2 as tgpt2
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
    fused_attention_block as tfab,
)
from test_torch_vit_kernels import bf16_ulp_of  # noqa: E402

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
WIDTH, HEADS, D_FF = 32, 4, 128
EPS = 1e-5
# GPT-2's init scale for the weights; x, the LayerNorms' parameters and the
# biases are of order 1 and 0.1
WEIGHT_STD = 0.02
# fp32: the block still rounds h, q, k, v, p, the attention output, h2 and
# the hidden to bf16 on both sides, and elsewhere only fp32 sums in another
# order (and XLA's exp and tanh against PyTorch's) differ: at least MIN_CLOSE
# of the elements within FP32_TOL (1 + |want|). A sum in another order can
# move an intermediate across a bf16 rounding boundary; the elements that
# depend on it (under the causal mask, every later position of a head whose
# k or v moved: about 1 % of the elements at 128 positions) move by about a
# bf16 ulp of the intermediate times a 0.02 weight, far less than FLIP_TOL
# (|want| + rms(want)), which every element is held to (the rule of
# tests/test_torch_vit_block.py).
FP32_TOL = 1e-5
MIN_CLOSE = 0.95
FLIP_TOL = 2.0 ** -12
# the CUDA fp32 form against its plain version on the card, besides the
# bf16 form's rule: at least this share of the elements within FP32_TOL
# (1 + |want|) (an output rounded to bf16 has about 0.3 % there), and a
# relative Frobenius error at most this fraction of the bf16 form's with
# casts around it
F32_CLOSE_FLOOR = 0.2
F32_REL_OF_BF16_CAST = 0.25
# bf16: every element within one bf16 ulp of JAX's and at least 99.9 % equal
MIN_EQUAL = 0.999
KEYS = tfab.GPT2_BLOCK_KEYS


def jax_fab():
    pytest.importorskip("jax")
    from explicit_alignment_for_vqa_tasks_tpu.ops import (
        fused_attention_block as jfab,
    )
    return jfab


def make_inputs(seed=0, batch=4, seq=16):
    """x, an all-valid mask and one layer's parameters, as numpy fp32."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    d, f = WIDTH, D_FF
    layer = {"ln1_scale": 1 + normal(d, scale=0.1),
             "ln1_bias": normal(d, scale=0.1),
             "attn_qkv": normal(d, 3 * d, scale=WEIGHT_STD),
             "attn_qkv_bias": normal(3 * d, scale=0.1),
             "attn_out": normal(d, d, scale=WEIGHT_STD),
             "attn_out_bias": normal(d, scale=0.1),
             "ln2_scale": 1 + normal(d, scale=0.1),
             "ln2_bias": normal(d, scale=0.1),
             "mlp_fc": normal(d, f, scale=WEIGHT_STD),
             "mlp_fc_bias": normal(f, scale=0.1),
             "mlp_proj": normal(f, d, scale=WEIGHT_STD),
             "mlp_proj_bias": normal(d, scale=0.1)}
    return normal(batch, seq, d), np.ones((batch, seq), np.int32), layer


def run_jax(x, mask, layer, dtype, group):
    jfab = jax_fab()
    import jax.numpy as jnp

    jd = getattr(jnp, dtype)
    out = jfab.fused_gpt2_block(
        jnp.asarray(x, jd), jnp.asarray(mask),
        *(jnp.asarray(layer[n], jd) for n in KEYS),
        num_heads=HEADS, group=group, eps=EPS, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def port_args(x, mask, layer, dtype):
    td = TORCH_DTYPES[dtype]
    return (torch.from_numpy(x).to(td), torch.from_numpy(mask),
            *(torch.from_numpy(layer[n]).to(td) for n in KEYS), HEADS)


def run_port(fn, x, mask, layer, dtype, group):
    out = fn(*port_args(x, mask, layer, dtype), group=group, eps=EPS)
    assert out.dtype == TORCH_DTYPES[dtype] and tuple(out.shape) == x.shape
    return out.float().numpy()


def assert_close(got, want, dtype):
    if dtype == "bfloat16":
        assert (np.abs(got - want) <= bf16_ulp_of(want)).all(), \
            np.abs(got - want).max()
        assert (got == want).mean() >= MIN_EQUAL, (got == want).mean()
        return
    flip = np.abs(got - want) / (np.abs(want) + np.sqrt(np.mean(want ** 2)))
    assert flip.max() <= FLIP_TOL, flip.max()
    close = np.abs(got - want) <= FP32_TOL * (1 + np.abs(want))
    assert close.mean() >= MIN_CLOSE, close.mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_plain_matches_pallas_kernel(group, dtype):
    """4 sequences of 16 positions; the group changes only the order of the
    sums when every row has a visible key."""
    x, mask, layer = make_inputs(seed=group)
    want = run_jax(x, mask, layer, dtype, group)
    got = run_port(tfab.fused_gpt2_block_plain, x, mask, layer, dtype, group)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_at_128_positions(dtype):
    """The longest sequence gpt2_forward sends to the kernel."""
    x, mask, layer = make_inputs(seed=5, batch=2, seq=128)
    want = run_jax(x, mask, layer, dtype, 4)
    got = run_port(tfab.fused_gpt2_block_plain, x, mask, layer, dtype, 4)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_key_mask_matches_pallas_kernel(dtype):
    """Right-padded rows of several lengths, as ClipCap's batches are."""
    x, mask, layer = make_inputs(seed=6)
    for b, valid in enumerate((16, 11, 7, 3)):
        mask[b, valid:] = 0
    want = run_jax(x, mask, layer, dtype, 4)
    got = run_port(tfab.fused_gpt2_block_plain, x, mask, layer, dtype, 4)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [4, 6])
def test_row_without_visible_key_averages_the_group(batch, dtype):
    """Left padding: the first rows of sequence 1 see no valid key, so the
    Pallas kernel's softmax is uniform over its whole group (G = 4 at B=4,
    G = 2 at B=6: the JAX wrapper halves the group until it divides B), and
    the output depends on the group's other sequences."""
    x, mask, layer = make_inputs(seed=7, batch=batch)
    mask[1, :5] = 0
    want = run_jax(x, mask, layer, dtype, 4)
    got = run_port(tfab.fused_gpt2_block_plain, x, mask, layer, dtype, 4)
    assert_close(got, want, dtype)
    # the group matters for those rows only: sequence 1 alone (G = 1) gives
    # them another value, and its other rows as the group does
    alone = run_port(tfab.fused_gpt2_block_plain, x, mask, layer, dtype, 1)
    assert np.abs(alone[1, :5] - want[1, :5]).max() > 1e-3
    assert_close(alone[1, 5:], got[1, 5:], dtype)


def test_group_is_halved_until_it_divides_the_batch():
    assert [tfab.gpt2_block_group(b) for b in (1, 2, 3, 4, 6, 8, 32)] == [
        1, 2, 1, 4, 2, 4, 4]
    assert tfab.gpt2_block_group(6, group=8) == 2


# --- gpt2_forward with the fused block --------------------------------------

@pytest.fixture(scope="module")
def lm():
    """GPT2Config.small_test params (fp32, numpy; JAX's init), the JAX
    tree and the port's."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from explicit_alignment_for_vqa_tasks_tpu.models import gpt2 as jgpt2

    cfg = jgpt2.GPT2Config.small_test()
    tree = jax.tree.map(np.asarray, jgpt2.init_gpt2_params(
        jax.random.PRNGKey(0), cfg, jnp.float32))
    # random LayerNorms and biases, so that every parameter is exercised
    rng = np.random.default_rng(11)
    for name, leaf in tree["blocks"].items():
        if "bias" in name or name.endswith("scale"):
            base = 1.0 if name.endswith("scale") else 0.0
            tree["blocks"][name] = (base + 0.1 * rng.standard_normal(
                leaf.shape)).astype(np.float32)
    return jgpt2, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gpt2_forward_matches_jax(lm, dtype):
    """Logits of 4 padded sequences of 12 tokens, both packages with
    fused_block=True (JAX's Pallas kernel in interpret mode)."""
    import jax.numpy as jnp

    jgpt2, tree = lm
    jd = getattr(jnp, dtype)
    jcfg = jgpt2.GPT2Config.small_test(dtype=jd, fused_block=True)
    tcfg = tgpt2.GPT2Config.small_test(dtype=TORCH_DTYPES[dtype],
                                       fused_block=True)
    rng = np.random.default_rng(12)
    ids = rng.integers(0, jcfg.vocab_size, (4, 12)).astype(np.int32)
    mask = np.ones((4, 12), np.int32)
    mask[1, 9:] = 0
    mask[3, 5:] = 0
    jparams = {k: (jnp.asarray(v, jd) if not isinstance(v, dict) else
                   {n: jnp.asarray(a, jd) for n, a in v.items()})
               for k, v in tree.items()}
    want = np.asarray(jgpt2.gpt2_forward(
        jparams, jcfg, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask)))
    tparams = gpt2_params_from_numpy(tree, TORCH_DTYPES[dtype], "cpu")
    before = tfab.fused_gpt2_block.launches
    got = tgpt2.gpt2_forward(tparams, tcfg, input_ids=torch.from_numpy(ids),
                             attention_mask=torch.from_numpy(mask)).numpy()
    assert tfab.fused_gpt2_block.launches == before   # CPU: plain version
    assert got.shape == (4, 12, jcfg.vocab_size) and got.dtype == np.float32
    if dtype == "float32":
        assert_close(got, want, dtype)
    else:
        # the bf16 residual stream over 2 layers, then the LM head: logits
        # within a few bf16 roundings of the final hidden state
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.97


def test_fused_forward_dispatches_at_most_128_positions(lm, monkeypatch):
    """gpt2_forward runs the block kernel at <= 128 positions only."""
    _, tree = lm
    cfg = tgpt2.GPT2Config.small_test(n_positions=160, fused_block=True)
    tree = dict(tree, wpe=np.random.default_rng(13).standard_normal(
        (160, cfg.d_model)).astype(np.float32) * 0.01)
    params = gpt2_params_from_numpy(tree, torch.float32, "cpu")
    calls = []
    real = tfab.fused_gpt2_block

    def counting(*args, **kw):
        calls.append(args[0].shape[1])
        return real(*args, **kw)

    monkeypatch.setattr(tfab, "fused_gpt2_block", counting)
    for length in (128, 129):
        ids = torch.zeros((1, length), dtype=torch.int32)
        tgpt2.gpt2_forward(params, cfg, input_ids=ids)
    assert calls == [128] * cfg.num_layers


def test_wrapper_takes_plain_version_on_cpu():
    x, mask, layer = make_inputs(seed=8, batch=2, seq=5)
    before = tfab.fused_gpt2_block.launches
    got = run_port(tfab.fused_gpt2_block, x, mask, layer, "bfloat16", 4)
    want = run_port(tfab.fused_gpt2_block_plain, x, mask, layer, "bfloat16",
                    4)
    np.testing.assert_array_equal(got, want)
    assert tfab.fused_gpt2_block.launches == before


# --- on the card: the CUDA kernel against the plain version -----------------

def cuda_block(batch, seq, cfg=None):
    """x, a mask and one GPT-2 small layer on the card, bf16: init-scale
    weights, random LayerNorm parameters and biases."""
    cfg = cfg or tgpt2.GPT2Config.gpt2_small(num_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    layer = {name: leaf[0] for name, leaf in tgpt2.init_gpt2_params(
        gen, cfg)["blocks"].items()}
    for name, leaf in layer.items():
        if name.endswith(("bias", "scale")):
            noise = torch.randn(leaf.shape, generator=gen, device="cuda")
            base = 1.0 if name.endswith("scale") else 0.0
            layer[name] = (base + 0.1 * noise).bfloat16()
    x = torch.randn((batch, seq, cfg.d_model), generator=gen,
                    device="cuda").bfloat16()
    mask = torch.ones((batch, seq), dtype=torch.int32, device="cuda")
    return x, mask, [layer[n] for n in KEYS], cfg.num_heads


@pytest.mark.gpu
@pytest.mark.parametrize("batch,seq,left_pad", [(8, 64, 0), (4, 128, 0),
                                                (6, 64, 7)])
def test_cuda_fused_gpt2_block_matches_plain_version(batch, seq, left_pad):
    """GPT-2 small widths: every element within 8e-3 (1 + |want|) of the
    plain version (the whole-block rule), one launch counted, a row with no
    visible key averaging its group (G = 2 at B = 6), grad inputs and fp16
    inputs refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, mask, params, heads = cuda_block(batch, seq)
    mask[:, seq - 9:] = 0
    mask[1, :left_pad] = 0
    before = tfab.fused_gpt2_block.launches
    got = tfab.fused_gpt2_block(x, mask, *params, heads)
    torch.cuda.synchronize()
    assert tfab.fused_gpt2_block.launches == before + 1
    want = tfab.fused_gpt2_block_plain(x, mask, *params, heads)
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got.float()).all())
    assert bool((err <= 8e-3 * (1 + want.float().abs())).all()), \
        err.max().item()
    # fp32 x takes the fp32 form (test_cuda_f32_fused_gpt2_block_matches_
    # plain_version); other dtypes are refused
    with pytest.raises(ValueError, match="bfloat16"):
        tfab.fused_gpt2_block(x.half(), mask, *params, heads)
    with pytest.raises(NotImplementedError, match="fused_gpt2_block_vjp"):
        tfab.fused_gpt2_block(x.clone().requires_grad_(), mask, *params,
                              heads)


@pytest.mark.gpu
@pytest.mark.parametrize("params_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("batch,seq,left_pad", [(8, 64, 0), (4, 128, 0),
                                                (6, 64, 7)])
def test_cuda_f32_fused_gpt2_block_matches_plain_version(batch, seq, left_pad,
                                                         params_dtype,
                                                         record_property):
    """The fp32 form at GPT-2 small widths: fp32 x, the parameters bf16 or
    fp32 (fp32 LayerNorms and biases no bf16 holds; the weights cast to
    bf16 by the wrapper), an fp32 output, one launch counted, a row with no
    visible key averaging its group. Its intermediates are the bf16 form's
    (bf16 h, q, k, v, p, attention and hidden), so it is held by the bf16
    form's whole-block rule, every element within 8e-3 (1 + |want|): on
    the card the tensor cores' sums round some of those intermediates the
    other way from the plain version's fp32 sums, and each such flip moves
    the later causal positions of its head. So that the fp32 loads and
    stores are held as well: at least F32_CLOSE_FLOOR of the elements
    within FP32_TOL (1 + |want|), and a relative Frobenius error at most
    F32_REL_OF_BF16_CAST of the bf16 form's with casts around it (the plain
    version on x rounded to bf16, its output rounded to bf16). The largest
    error over (|want| + rms) and the readings are recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, mask, params, heads = cuda_block(batch, seq)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(x.shape, generator=gen, device="cuda")
    if params_dtype == "float32":
        params = [p.float() + (1e-3 * torch.rand(p.shape, generator=gen,
                                                 device="cuda")
                               if p.dim() == 1 else 0) for p in params]
    mask[:, seq - 9:] = 0
    mask[1, :left_pad] = 0
    before = tfab.fused_gpt2_block.launches
    got = tfab.fused_gpt2_block(x, mask, *params, heads)
    torch.cuda.synchronize()
    assert tfab.fused_gpt2_block.launches == before + 1
    want = tfab.fused_gpt2_block_plain(x, mask, *params, heads)
    assert got.dtype == want.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs()
    assert bool((err <= 8e-3 * (1 + want.abs())).all()), err.max().item()
    rms = want.square().mean().sqrt()
    close = (err <= FP32_TOL * (1 + want.abs())).float().mean().item()
    rel = ((got - want).norm() / want.norm()).item()
    cast = tfab.fused_gpt2_block_plain(x.bfloat16().float(), mask, *params,
                                       heads).bfloat16().float()
    cast_rel = ((cast - want).norm() / want.norm()).item()
    record_property("flip_max", (err / (want.abs() + rms)).max().item())
    record_property("close_share", close)
    record_property("rel_frobenius", rel)
    record_property("bf16_cast_rel_frobenius", cast_rel)
    assert close >= F32_CLOSE_FLOOR, close
    assert rel <= F32_REL_OF_BF16_CAST * cast_rel, (rel, cast_rel)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,seq,left_pad", [(8, 64, 0), (6, 128, 7)])
def test_cuda_f32_form_rounds_to_the_bf16_form(batch, seq, left_pad):
    """On x that bf16 holds, with bf16 parameters, the fp32 form's output
    rounded to bf16 is the bf16 form's bit for bit: both run the same
    stages on the same values, and only the fp32 form's last store is not
    rounded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, mask, params, heads = cuda_block(batch, seq)
    mask[:, seq - 9:] = 0
    mask[1, :left_pad] = 0
    got = tfab.fused_gpt2_block(x.float(), mask, *params, heads)
    want = tfab.fused_gpt2_block(x, mask, *params, heads)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got.bfloat16(), want)


@pytest.mark.gpu
def test_cuda_tile_widths_agree_bit_for_bit():
    """At M = 2,048 (32 sequences of 64) the out-projection and the down
    product (N = 768) take 128-wide tiles, since 256-wide ones would be
    fewer than the SMs; in a batch large enough for 256-wide tiles the same
    32 sequences come out bit for bit the same (each output sums its k
    steps in the same order at either width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x, mask, params, heads = cuda_block(32, 64)
    d_model = x.shape[-1]
    assert 2048 // 128 * (d_model // 256) < sms
    repeat = -(-sms // (2048 // 128 * (d_model // 256)))
    big = torch.cat([x] + [torch.randn_like(x) for _ in range(repeat - 1)])
    assert big.shape[0] * 64 // 128 * (d_model // 256) >= sms
    small_out = tfab.fused_gpt2_block(x, mask, *params, heads)
    big_out = tfab.fused_gpt2_block(big, mask.repeat(repeat, 1), *params,
                                    heads)
    torch.cuda.synchronize()
    assert torch.equal(small_out, big_out[:32])


@pytest.mark.gpu
def test_cuda_qkv_thirds_match_separate_weights():
    """The q | k | v stage over the three column-third tensor maps of the
    fused (D, 3 D) weight (row stride 3 D, no copy) gives q, k and v bit
    for bit as fused_ln_qkv over the thirds copied into separate (D, D)
    weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, _, params, heads = cuda_block(32, 64)
    ln_s, ln_b, w_qkv, b_qkv = params[:4]
    rows, d_model = 32 * 64, x.shape[-1]
    scale = (d_model // heads) ** -0.5
    h = torch.empty((rows, d_model), dtype=torch.bfloat16, device="cuda")
    q, k, v = (torch.empty_like(x) for _ in range(3))
    launch = tfab._launcher_of("gpt2_block", "gpt2_ln_qkv", 9, 2, 2)
    rc = launch(x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
                w_qkv.data_ptr(), b_qkv.data_ptr(), h.data_ptr(),
                q.data_ptr(), k.data_ptr(), v.data_ptr(), rows, d_model,
                scale, EPS, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    thirds = [t for i in range(3) for t in (
        w_qkv[:, i * d_model:(i + 1) * d_model].contiguous(),
        b_qkv[i * d_model:(i + 1) * d_model].contiguous())]
    want = tfab.fused_ln_qkv(x, ln_s, ln_b, *thirds, scale, eps=EPS)
    torch.cuda.synchronize()
    for got, ref in zip((q, k, v), want):
        assert torch.equal(got, ref)


@pytest.mark.gpu
def test_cuda_gpt2_forward_fused_matches_unfused():
    """2 layers of GPT-2 small on 4 sequences of 64 tokens: the fused
    forward's logits against the unfused plain path's, per-position cosine
    at least 0.999; 2 launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tgpt2.GPT2Config.gpt2_small(num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tgpt2.init_gpt2_params(gen, cfg)
    ids = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                        device="cuda")
    with torch.inference_mode():
        base = tgpt2.gpt2_forward(params, cfg, input_ids=ids)
        before = tfab.fused_gpt2_block.launches
        fused = tgpt2.gpt2_forward(
            params, dataclasses.replace(cfg, fused_block=True), input_ids=ids)
    assert tfab.fused_gpt2_block.launches == before + 2
    cos = torch.nn.functional.cosine_similarity(base, fused, dim=-1)
    assert cos.min().item() >= 0.999, cos.min().item()
