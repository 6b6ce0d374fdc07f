"""The port's CLIP ViT split3 kernels (fused_ln_qkv, attention_core_oproj,
fused_mlp_block): each plain version against the JAX package's Pallas
kernel (interpret mode on the CPU) in bf16 and fp32 and at a short sequence
with group 2, the wrappers on CPU tensors, the kernel library's name keyed
by the headers it includes, and the CUDA kernels against the plain versions
on the card."""

import shutil

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch import kernels
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
    fused_attention_block as tfab,
)

KERNELS = ("fused_ln_qkv", "attention_core_oproj", "fused_mlp_block")
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# seq 197 = (168 / 12)^2 + 1, the long-sequence tower of
# tests/test_vit_long_variants.py
BATCH, SEQ, WIDTH, HEADS, D_FF = 2, 197, 64, 4, 256
EPS = 1e-5
# bf16: every element within one bf16 ulp of JAX's and at least 99.9 %
# equal (both sides round at the same places; fp32 sums in another order
# can move a value across a bf16 rounding boundary).
MIN_EQUAL = 0.999
# fp32: |port - jax| <= FP32_TOL (|jax| + rms(jax)) + the bound of the bf16
# roundings of h and hid that may go the other way (fp32 sum order puts
# the port's value within NEAR_ULPS fp32 ulps of a bf16 midpoint).
FP32_TOL = 1e-5
NEAR_ULPS = 16
BF16_ULP = 2.0 ** -7 * 1.01       # a bf16 ulp of t is at most this x |t|
QUICK_GELU_SLOPE = 1.13           # max |d/dz z sigmoid(1.702 z)|


def bf16_valued(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def make_inputs(seed=0, batch=BATCH, seq=SEQ):
    """x, LN params, bf16-valued weights (as the Pallas wrappers cast
    them), biases, and pre-scaled q, k, v for the attention kernel."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    d, f = WIDTH, D_FF
    return dict(
        x=normal(batch, seq, d), ln_s=1 + normal(d, scale=0.1),
        ln_b=normal(d, scale=0.1),
        w=[bf16_valued(normal(d, d, scale=d ** -0.5)) for _ in range(4)],
        b=[normal(d, scale=0.1) for _ in range(4)],
        w_fc=bf16_valued(normal(d, f, scale=d ** -0.5)), b_fc=normal(f, scale=0.1),
        w_proj=bf16_valued(normal(f, d, scale=f ** -0.5)),
        b_proj=normal(d, scale=0.1),
        qkv=[normal(batch, seq, d, scale=s) for s in (0.5, 2.0, 1.0)],
    )


def scale():
    return (WIDTH // HEADS) ** -0.5


def run_jax(name, inp, dtype, group=1):
    jnp = pytest.importorskip("jax.numpy")
    from explicit_alignment_for_vqa_tasks_tpu.ops import (
        fused_attention_block as jfab,
    )

    jd = getattr(jnp, dtype)

    def a(t):
        return jnp.asarray(t, jd)

    if name == "fused_ln_qkv":
        out = jfab.fused_ln_qkv(
            a(inp["x"]), a(inp["ln_s"]), a(inp["ln_b"]),
            *[a(t) for i in range(3) for t in (inp["w"][i], inp["b"][i])],
            scale=scale(), group=group, eps=EPS, interpret=True)
    elif name == "attention_core_oproj":
        out = (jfab.attention_core_oproj(
            a(inp["x"]), *[a(t) for t in inp["qkv"]], a(inp["w"][3]),
            a(inp["b"][3]), num_heads=HEADS, group=group, interpret=True),)
    else:
        out = (jfab.fused_mlp_block(
            a(inp["x"]), a(inp["ln_s"]), a(inp["ln_b"]), a(inp["w_fc"]),
            a(inp["b_fc"]), a(inp["w_proj"]), a(inp["b_proj"]), group=group,
            eps=EPS, interpret=True),)
    return [np.asarray(o.astype(jnp.float32)) for o in out]


def port_args(name, inp, dtype):
    td = TORCH_DTYPES[dtype]

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(td)

    if name == "fused_ln_qkv":
        return (t(inp["x"]), t(inp["ln_s"]), t(inp["ln_b"]),
                *[t(a) for i in range(3) for a in (inp["w"][i], inp["b"][i])],
                scale())
    if name == "attention_core_oproj":
        return (t(inp["x"]), *[t(a) for a in inp["qkv"]], t(inp["w"][3]),
                t(inp["b"][3]), HEADS)
    return (t(inp["x"]), t(inp["ln_s"]), t(inp["ln_b"]), t(inp["w_fc"]),
            t(inp["b_fc"]), t(inp["w_proj"]), t(inp["b_proj"]))


def run_port(fn, name, inp, dtype, **kw):
    out = fn(*port_args(name, inp, dtype), **kw)
    out = out if isinstance(out, tuple) else (out,)
    for o in out:
        assert o.dtype == TORCH_DTYPES[dtype]
        assert tuple(o.shape) == inp["x"].shape
    return [o.float().numpy() for o in out]


def near_bf16_boundary(a):
    """Where an fp32 value lies within NEAR_ULPS ulps of the midpoint
    between its two neighbouring bf16 values."""
    a = np.ascontiguousarray(a, np.float32)
    bits = a.view(np.uint32) & np.uint32(0xFFFF0000)
    lower = bits.view(np.float32).astype(np.float64)
    upper = (bits + np.uint32(0x10000)).view(np.float32).astype(np.float64)
    return np.abs(a - (lower + upper) / 2) <= NEAR_ULPS * np.spacing(
        np.abs(a))


def flips(t):
    """How far a bf16 rounding of each fp32 value may go the other way."""
    return near_bf16_boundary(t) * np.abs(t) * BF16_ULP


def fp32_flip_bounds(name, inp):
    """Per output element, how far the port's fp32 output may move for the
    bf16 roundings of h (and hid) that lie near a boundary."""
    if name == "attention_core_oproj":     # no bf16 rounding in fp32
        return [0.0]
    x = torch.from_numpy(inp["x"]).reshape(-1, WIDTH)
    h = tfab._ln_f32(x, torch.from_numpy(inp["ln_s"]),
                     torch.from_numpy(inp["ln_b"]), EPS)
    dh = flips(h.numpy())
    shape = inp["x"].shape
    if name == "fused_ln_qkv":
        return [(dh @ np.abs(inp["w"][i]) * (scale() if i == 0 else 1.0))
                .reshape(shape) for i in range(3)]
    pre = h.bfloat16().float() @ torch.from_numpy(inp["w_fc"]) \
        + torch.from_numpy(inp["b_fc"])
    hid = (pre * torch.sigmoid(1.702 * pre)).numpy()
    d_pre = dh @ np.abs(inp["w_fc"])
    d_hid = (QUICK_GELU_SLOPE * d_pre + (d_pre > 0) * np.abs(hid) * BF16_ULP
             + flips(hid))
    return [(d_hid @ np.abs(inp["w_proj"])).reshape(shape)]


def bf16_ulp_of(a):
    a = np.abs(np.asarray(a, np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(a, 2.0 ** -126))) - 7)


def assert_close(name, got, want, dtype, inp):
    if dtype == "bfloat16":
        for g, w in zip(got, want):
            assert (np.abs(g - w) <= bf16_ulp_of(w)).all(), \
                (name, np.abs(g - w).max())
            equal = (g == w).mean()
            assert equal >= MIN_EQUAL, (name, equal)
        return
    for g, w, bound in zip(got, want, fp32_flip_bounds(name, inp)):
        rms = np.sqrt(np.mean(np.square(w)))
        limit = FP32_TOL * (np.abs(w) + rms) + bound
        assert (np.abs(g - w) <= limit).all(), (name, np.abs(g - w).max())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", KERNELS)
def test_plain_matches_pallas_kernel(name, dtype):
    inp = make_inputs()
    want = run_jax(name, inp, dtype)
    got = run_port(getattr(tfab, name + "_plain"), name, inp, dtype)
    assert_close(name, got, want, dtype, inp)


@pytest.mark.parametrize("name", KERNELS)
def test_short_sequence_with_group_2(name):
    """B=4 at 50 tokens with group 2, as the short-sequence split3 path
    calls the kernels: the port ignores the group (it only tiles the TPU
    grid), so the wrapper's result equals its group-1 result and holds
    JAX's group-2 kernel within one bf16 ulp."""
    inp = make_inputs(seed=5, batch=4, seq=50)
    want = run_jax(name, inp, "bfloat16", group=2)
    got = run_port(getattr(tfab, name), name, inp, "bfloat16", group=2)
    ungrouped = run_port(getattr(tfab, name), name, inp, "bfloat16")
    for g, u in zip(got, ungrouped):
        np.testing.assert_array_equal(g, u)
    assert_close(name, got, want, "bfloat16", inp)


@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_takes_plain_version_on_cpu(name):
    inp = make_inputs(seed=1)
    fn = getattr(tfab, name)
    before = fn.launches
    got = run_port(fn, name, inp, "bfloat16")
    want = run_port(getattr(tfab, name + "_plain"), name, inp, "bfloat16")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert fn.launches == before


@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_checks_the_group(name):
    inp = make_inputs(seed=2, batch=3, seq=5)
    with pytest.raises(ValueError, match="group"):
        getattr(tfab, name)(*port_args(name, inp, "float32"), group=2)


def test_plain_rounds_the_norm_to_bf16_for_fp32_inputs():
    """Like the Pallas kernel, the plain version feeds the projections
    bf16(LN(x)) whatever x's dtype: fp32 q differs from the unrounded
    projection by far more than fp32 noise."""
    inp = make_inputs(seed=3)
    x = torch.from_numpy(inp["x"])
    h = tfab._ln_f32(x, torch.from_numpy(inp["ln_s"]),
                     torch.from_numpy(inp["ln_b"]), EPS)
    unrounded = (h @ torch.from_numpy(inp["w"][0])
                 + torch.from_numpy(inp["b"][0])) * scale()
    q = tfab.fused_ln_qkv_plain(*port_args("fused_ln_qkv", inp, "float32"))[0]
    assert (q - unrounded).abs().max().item() > 1e-4


def test_library_path_covers_included_headers(tmp_path, monkeypatch):
    """Editing a header under csrc/ renames the libraries of the sources
    that include it (and only theirs), so no stale build is loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    before = {name: kernels.library_path(name) for name in kernels.SOURCES}
    assert kernels.SOURCES["vit_block"] == "vit_block.cu"
    assert [p.name for p in kernels.included_files("vit_block")] == [
        "vit_block.cu", "block_stages.cuh", "vit_attention.cuh",
        "bf16_gemm.cuh"]
    header = csrc / "bf16_gemm.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: kernels.library_path(name) for name in kernels.SOURCES}
    for name in kernels.SOURCES:
        changed = before[name] != after[name]
        uses_header = "bf16_gemm.cuh" in [
            p.name for p in kernels.included_files(name)]
        assert changed == uses_header, name
    assert after["vit_block"].name.startswith("vit_block-")
    assert after["vit_block"].parent == kernels.BUILD_DIR


# --- on the card: the CUDA kernels against the plain versions --------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", KERNELS)
def test_cuda_kernel_matches_plain_version(name):
    """ViT-L/14@336 widths (L 577, D 1024, 16 heads, F 4096) on 2 images,
    bf16: every element within 8e-3 (1 + |want|) of the plain version, one
    launch counted, and fp32 inputs refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).bfloat16()

    batch, seq, width, heads, d_ff = 2, 577, 1024, 16, 4096
    x = randn(batch, seq, width)
    ln_s, ln_b = 1 + randn(width, scale=0.1), randn(width, scale=0.1)
    w = [randn(width, width, scale=width ** -0.5) for _ in range(4)]
    b = [randn(width, scale=0.1) for _ in range(4)]
    if name == "fused_ln_qkv":
        args = (x, ln_s, ln_b, w[0], b[0], w[1], b[1], w[2], b[2],
                (width // heads) ** -0.5)
    elif name == "attention_core_oproj":
        q, k, v = (randn(batch, seq, width, scale=s) for s in (0.5, 2.0, 1.0))
        args = (x, q, k, v, w[3], b[3], heads)
    else:
        args = (x, ln_s, ln_b, randn(width, d_ff, scale=width ** -0.5),
                randn(d_ff, scale=0.1), randn(d_ff, width, scale=d_ff ** -0.5),
                randn(width, scale=0.1))
    fn, plain = getattr(tfab, name), getattr(tfab, name + "_plain")
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, p in zip(got, want):
        g, p = g.float(), p.float()
        assert bool(((g - p).abs() <= 8e-3 * (1 + p.abs())).all()), \
            (g - p).abs().max().item()
    with pytest.raises(ValueError, match="bfloat16"):
        fn(args[0].float(), *args[1:])
