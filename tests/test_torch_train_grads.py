"""The port's autograd forms of the three differentiable kernels,
t5_attention_core_vjp, fused_t5_ffn_vjp and fused_gpt2_block_vjp, against
jax.vjp of the JAX package's custom_vjp forms (their Pallas forwards in
interpret mode on the CPU), bf16 and fp32, with a masked key and a fully
masked row; torch.autograd.gradcheck of the three XLA twins they
differentiate, lifted to float64; and the guard every CUDA kernel wrapper
runs before it launches: with grad enabled, an input that requires a
gradient raises (shown on meta tensors, which take the CUDA path)."""

import inspect

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.ops import (  # noqa: E402
    fused_attention_block as jfab,
)
from explicit_alignment_for_vqa_tasks_tpu_torch import kernels  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (  # noqa: E402
    attention as tattention,
    decode_attention as tdecode,
    fused_attention_block as tfab,
)
from test_torch_gpt2_block import make_inputs as gpt2_inputs  # noqa: E402

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Each gradient is held within REL of its largest element. Both sides
# differentiate the same twin; fp32 gradients differ by sums in another
# order; bf16 ones by at most a bf16 rounding (2^-8 of the largest) where a
# sum lands on another side of one. The gated FFN's fp32 dx and dln are
# the exception: its normed h is bf16 in the twin and read by two
# products, and XLA, which may keep excess precision, drops some of the
# bf16 roundings of h's cotangent that the port makes (measured 6e-4 of
# the largest), so it is held to the bf16 rule.
REL = {"float32": 1e-4, "bfloat16": 2.0 ** -8}
B, L, HEADS, HEAD_DIM = 2, 9, 2, 16
D_MODEL, D_FF, EPS = 64, 128, 1e-6


def bf16_valued(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def assert_grad_close(name, got, want, rel):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (name, err, np.abs(want).max())


def masks():
    """Key 6-8 of row 0 masked; every key of row 1 masked."""
    mask = np.ones((B, L), np.int32)
    mask[0, -3:] = 0
    mask[1, :] = 0
    return mask


def port_grads(fn, arrays, dtypes, d_out, *rest):
    """fn(*tensors, *rest) backward from d_out; each array's gradient."""
    tensors = [None if a is None else torch.tensor(a, dtype=d,
                                                   requires_grad=True)
               for a, d in zip(arrays, dtypes)]
    out = fn(*tensors, *rest)
    out.backward(torch.tensor(d_out, dtype=out.dtype))
    return [None if t is None else t.grad.float().numpy() for t in tensors]


# --- t5_attention_core_vjp ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_core_vjp_grads_match_jax(dtype):
    rng = np.random.default_rng(0)
    width = HEADS * HEAD_DIM
    q, k, v, d_out = (bf16_valued(rng.standard_normal((B, L, width)))
                      for _ in range(4))
    bias = rng.standard_normal((HEADS, L, L)).astype(np.float32)
    mask = masks()
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    _, vjp = jax.vjp(
        lambda q_, k_, v_, b_: jfab.t5_attention_core_vjp(
            q_, k_, v_, b_, jnp.asarray(mask), HEADS),
        *(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(bias))
    want = vjp(jnp.asarray(d_out, jd))
    got = port_grads(
        lambda *t: tfab.t5_attention_core_vjp(*t, torch.from_numpy(mask),
                                              HEADS),
        (q, k, v, bias), (td, td, td, torch.float32), d_out)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert_grad_close(name, g, np.asarray(w.astype(jnp.float32)),
                          REL["float32" if name == "dbias" else dtype])


def test_attention_core_vjp_computes_only_the_grads_asked_for():
    """A frozen input (here the position bias) gets no gradient, and mask
    never does; the forward is the wrapper's (the plain version here)."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.standard_normal((B, L, 32)),
                            dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    bias = torch.tensor(rng.standard_normal((HEADS, L, L)),
                        dtype=torch.float32)
    mask = torch.from_numpy(masks())
    out = tfab.t5_attention_core_vjp(q, k, v, bias, mask, HEADS)
    torch.testing.assert_close(
        out, tfab.t5_attention_core_plain(q, k, v, bias, mask, HEADS),
        rtol=0, atol=0)
    out.sum().backward()
    assert bias.grad is None and q.grad is not None and v.grad is not None


# --- fused_t5_ffn_vjp ----------------------------------------------------------

@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_t5_ffn_vjp_grads_match_jax(dtype, gated):
    rng = np.random.default_rng(2)
    x = bf16_valued(rng.standard_normal((B, L, D_MODEL)) * 2)
    lnw = (1 + 0.1 * rng.standard_normal(D_MODEL)).astype(np.float32)

    def w(k, n):
        return bf16_valued(rng.standard_normal((k, n)) * k ** -0.5)

    wi_0 = w(D_MODEL, D_FF)
    wi_1 = w(D_MODEL, D_FF) if gated else None
    wo = w(D_FF, D_MODEL)
    d_out = bf16_valued(rng.standard_normal((B, L, D_MODEL)))
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    arrays = [x, lnw, wi_0, wi_1, wo]
    live = [i for i, a in enumerate(arrays) if a is not None]

    def jax_fn(*live_args):
        full = [None] * 5
        for i, a in zip(live, live_args):
            full[i] = a
        return jfab.fused_t5_ffn_vjp(*full, EPS)

    _, vjp = jax.vjp(jax_fn, jnp.asarray(x, jd),
                     *(jnp.asarray(arrays[i]) for i in live[1:]))
    want = vjp(jnp.asarray(d_out, jd))
    got = port_grads(
        lambda *t: tfab.fused_t5_ffn_vjp(*t, EPS), arrays,
        (td,) + (torch.float32,) * 4, d_out)
    for i, w_grad in zip(live, want):
        rel = REL[dtype if i == 0 else "float32"]
        if gated and i in (0, 1):
            rel = REL["bfloat16"]
        assert_grad_close(f"d{i}", got[i], np.asarray(
            w_grad.astype(jnp.float32)), rel)


# --- fused_gpt2_block_vjp --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpt2_block_vjp_grads_match_jax(dtype):
    """A masked key tail, and query 0 of row 0 with no visible valid key
    (the twin's softmax there is uniform, not the kernel's group average;
    both packages differentiate the twin)."""
    x, mask, layer = gpt2_inputs(0, batch=B, seq=12)
    mask[1, -4:] = 0
    mask[0, 0] = 0
    params = [layer[n] for n in tfab.GPT2_BLOCK_KEYS]
    d_out = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)
    jd, td = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    _, vjp = jax.vjp(
        lambda x_, *p: jfab.fused_gpt2_block_vjp(
            x_, jnp.asarray(mask), *p, 4, 1e-5),
        jnp.asarray(x, jd), *(jnp.asarray(p, jd) for p in params))
    want = vjp(jnp.asarray(d_out, jd))
    got = port_grads(
        lambda x_, *p: tfab.fused_gpt2_block_vjp(
            x_, torch.from_numpy(mask), *p, 4, 1e-5),
        [x] + params, (td,) * 13, d_out)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_grad_close(f"d{i}", g, np.asarray(w.astype(jnp.float32)),
                          REL[dtype])


# --- the twins, lifted to float64 ------------------------------------------------

F64 = dict(dtype=torch.float64)


def f64(*shape, scale=1.0, seed=0, offset=0.0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen, **F64) * scale + offset) \
        .requires_grad_()


def test_twins_gradcheck_in_float64():
    """Each twin with its fp32 and bf16 steps lifted to float64 is smooth:
    its autograd gradient equals finite differences, for every float input
    (torch.autograd.gradcheck; tiny widths, since it takes two twin calls
    an input element)."""
    wide = dict(wide=torch.float64)
    both = dict(wide=torch.float64, narrow=torch.float64)
    # a masked key, no fully masked row: there every score sits near -1e9,
    # where float64's spacing is 1e-7 and finite differences see steps
    mask = torch.ones((B, 4), dtype=torch.int32)
    mask[1, -1:] = 0
    q, k, v = (f64(B, 4, 4, seed=i) for i in range(3))
    assert torch.autograd.gradcheck(
        lambda *t: tfab._t5_attention_reference(*t[:3], t[3], mask, 2,
                                                **wide),
        (q, k, v, f64(2, 4, 4, seed=3)))
    d, f = 4, 8
    ffn = (f64(2, 2, d, seed=4), f64(d, seed=5, scale=0.1, offset=1.0),
           f64(d, f, seed=6, scale=0.5), f64(d, f, seed=7, scale=0.5),
           f64(f, d, seed=8, scale=0.35))
    assert torch.autograd.gradcheck(
        lambda *t: tfab._t5_ffn_reference(*t, EPS, **both), ffn)
    gmask = torch.ones((2, 3), dtype=torch.int32)
    gmask[1, -1:] = 0
    block = (f64(2, 3, d, seed=9), f64(d, seed=10, scale=0.1, offset=1.0),
             f64(d, seed=11, scale=0.1), f64(d, 3 * d, seed=12, scale=0.5),
             f64(3 * d, seed=13, scale=0.1), f64(d, d, seed=14, scale=0.5),
             f64(d, seed=15, scale=0.1),
             f64(d, seed=16, scale=0.1, offset=1.0),
             f64(d, seed=17, scale=0.1), f64(d, f, seed=18, scale=0.5),
             f64(f, seed=19, scale=0.1), f64(f, d, seed=20, scale=0.35),
             f64(d, seed=21, scale=0.1))
    assert torch.autograd.gradcheck(
        lambda x, *p: tfab._gpt2_block_reference(x, gmask, *p, 2, 1e-5,
                                                 **both), block)


# --- the guard of the CUDA kernel wrappers --------------------------------------

def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def wrapper_calls():
    """(wrapper, vjp name or None, call) for every kernel wrapper, its
    first float input requiring a gradient; the shapes are never read."""
    x = meta(2, 4, 128).requires_grad_()
    w, s = meta(128, 128), meta(1, 128, dtype=torch.float32)
    w8 = meta(128, 128, dtype=torch.int8)
    vec = meta(128)
    gpt2 = [vec, vec, w, meta(384), w, vec, vec, vec, w, vec, w, vec]
    vit = [vec, vec, w, vec, w, vec, w, vec, w, vec, vec, vec, w, vec, w,
           vec]
    vit_q8 = [vec, vec, w8, s, vec, w8, s, vec, vec, vec, w8, s, vec, w8,
              s, vec]
    mask = meta(2, 4, dtype=torch.int32)
    return [
        (tfab.t5_attention_core, "t5_attention_core_vjp",
         lambda: tfab.t5_attention_core(x, x, x, meta(4, 4, 4), mask, 4)),
        (tfab.fused_t5_ffn, "fused_t5_ffn_vjp",
         lambda: tfab.fused_t5_ffn(x, vec, w, w, w)),
        (tfab.fused_gpt2_block, "fused_gpt2_block_vjp",
         lambda: tfab.fused_gpt2_block(x, mask, *gpt2, num_heads=2)),
        (tfab.fused_t5_ln_qkv_q8, None,
         lambda: tfab.fused_t5_ln_qkv_q8(x, vec, w8, s, w8, s, w8, s)),
        (tfab.fused_oproj_residual_q8, None,
         lambda: tfab.fused_oproj_residual_q8(x, x, w8, s)),
        (tfab.fused_t5_ffn_q8, None,
         lambda: tfab.fused_t5_ffn_q8(x, vec, w8, s, w8, s, w8, s)),
        (tfab.fused_ln_qkv, None,
         lambda: tfab.fused_ln_qkv(x, vec, vec, w, vec, w, vec, w, vec,
                                   0.125)),
        (tfab.attention_core_oproj, None,
         lambda: tfab.attention_core_oproj(x, x, x, x, w, vec, 2)),
        (tfab.fused_mlp_block, None,
         lambda: tfab.fused_mlp_block(x, vec, vec, w, vec, w, vec)),
        (tfab.attention_core, None,
         lambda: tfab.attention_core(x, x, x, 2)),
        (tfab.fused_qkv_q8, None,
         lambda: tfab.fused_qkv_q8(x, vec, vec, w8, s, meta(384), 0.125)),
        (tfab.fused_mlp_block_q8, None,
         lambda: tfab.fused_mlp_block_q8(x, vec, vec, w8, s, vec, w8, s,
                                         vec)),
        (tfab.fused_vit_block, None,
         lambda: tfab.fused_vit_block(x, *vit, num_heads=2, group=2)),
        (tfab.fused_vit_block_q8, None,
         lambda: tfab.fused_vit_block_q8(x, vec, vec, w8, s, meta(384), w8,
                                         s, vec, vec, vec, w8, s, vec, w8,
                                         s, vec, num_heads=2, group=2)),
        (tfab.fused_attention_block, None,
         lambda: tfab.fused_attention_block(x, w, vec, w, vec, w, vec, w,
                                            vec, num_heads=2, group=2)),
        (tattention.flash_attention, None,
         lambda: tattention.flash_attention(meta(2, 4, 2, 64)
                                            .requires_grad_(),
                                            meta(2, 4, 2, 64),
                                            meta(2, 4, 2, 64))),
        (tdecode.cross_attention_decode, None,
         lambda: tdecode.cross_attention_decode(
             meta(2, 128).requires_grad_(), meta(1, 2, 4, 128),
             meta(1, 2, 4, 128), mask, 0, 2)),
    ]


@pytest.mark.parametrize("index", range(17))
def test_cuda_wrapper_refuses_grad_before_launching(index):
    """Off the CPU, with grad enabled, an input that requires a gradient
    raises before any kernel is built or launched, naming the autograd form
    where there is one."""
    fn, vjp, call = wrapper_calls()[index]
    before = fn.launches
    with pytest.raises(NotImplementedError,
                       match=vjp or "no autograd form"):
        call()
    assert fn.launches == before


def test_every_kernel_wrapper_is_guarded():
    """Every function that counts kernel launches calls the guard, and the
    list above names each of them."""
    wrappers = [obj for module in (tfab, tattention, tdecode)
                for obj in vars(module).values()
                if inspect.isfunction(obj) and hasattr(obj, "launches")]
    assert {fn.__name__ for fn in wrappers} == {
        fn.__name__ for fn, _, _ in wrapper_calls()}
    for fn in wrappers:
        assert "kernels.refuse_grad(" in inspect.getsource(fn), fn.__name__


def test_refuse_grad_only_under_grad():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="op: the CUDA kernel"):
        kernels.refuse_grad("op", None, x)
    with torch.no_grad():
        kernels.refuse_grad("op", x)
    kernels.refuse_grad("op", x.detach(), None)
