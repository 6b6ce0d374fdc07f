"""The fp32 forms of the int8 CLIP ViT kernels (fused_qkv_q8,
fused_mlp_block_q8, fused_vit_block_q8): fp32 activations, or bf16 ones with
fp32 LayerNorms and biases (the weights int8, their scales fp32, in every
form). On the CPU: the form each CUDA call launches (a recording launcher on
meta tensors) and the refusal of other dtypes; the int8 tower of the port
against the JAX package's (its Pallas kernels in interpret mode) in those
dtypes, at the whole-block branch (5 tokens) and at the long-sequence
branch (197 tokens); the whole block's fp32 rule failing forms that round
x, r1 or the output to bf16 (mutants of the plain version). On the card: each kernel's forms against their plain
versions at ViT-L/14@336's widths (577 and 197 tokens) and ViT-B/32's (50
tokens)."""

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (
    clip_vision_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import clip as tclip
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
    fused_attention_block as tfab,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import (
    clip_encoder as tenc,
)
from test_torch_vit_q8_kernels import exact_mlp_case, exact_qkv_case
from test_torch_vit_whole_f32 import (  # noqa: F401 (recorded: a fixture)
    bf16,
    block_layer,
    recorded,
)

F32, BF16, I8 = torch.float32, torch.bfloat16, torch.int8
KERNELS = ("fused_qkv_q8", "fused_mlp_block_q8", "fused_vit_block_q8")
# (activations, LayerNorms and biases) -> (x_f32, params_f32) of the launch
FORMS = {(BF16, BF16): (0, 0), (BF16, F32): (0, 1), (F32, BF16): (1, 0),
         (F32, F32): (1, 1)}


def form_id(form):
    return "-".join(str(t).removeprefix("torch.") for t in form)


# --- on the CPU: the recorded launches --------------------------------------

def meta_args(name, act, vec, batch=2, seq=577, width=1024, heads=16):
    """The wrapper's positional arguments as meta tensors: x of act, the
    LayerNorms' parameters and the biases of vec, int8 weights with fp32
    scales."""
    d_ff = 4 * width

    def t(*shape, dtype=vec):
        return torch.empty(shape, dtype=dtype, device="meta")

    x = t(batch, seq, width, dtype=act)
    ln = (t(width), t(width))
    qkv = (t(width, 3 * width, dtype=I8), t(3 * width, dtype=F32),
           t(3 * width))
    mlp = (t(width, d_ff, dtype=I8), t(d_ff, dtype=F32), t(d_ff),
           t(d_ff, width, dtype=I8), t(width, dtype=F32), t(width))
    if name == "fused_qkv_q8":
        return (x, *ln, *qkv, (width // heads) ** -0.5)
    if name == "fused_mlp_block_q8":
        return (x, *ln, *mlp)
    o = (t(width, width, dtype=I8), t(width, dtype=F32), t(width))
    return (x, *ln, *qkv, *o, t(width), t(width), *mlp, heads)


# each kernel at its path's shape: rows 13 and 14 at ViT-L/14@336's 577
# tokens, row 12 at ViT-B/32's 50 (12 heads of 64)
META_SHAPES = {"fused_qkv_q8": dict(seq=577, width=1024, heads=16),
               "fused_mlp_block_q8": dict(seq=577, width=1024, heads=16),
               "fused_vit_block_q8": dict(seq=50, width=768, heads=12)}


@pytest.mark.parametrize("form", list(FORMS), ids=form_id)
@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_launches_the_form_of_its_dtypes(recorded, name, form):
    """One launch counted, with the form's x_f32 and params_f32 flags; the
    outputs in x's dtype and shape."""
    shape = META_SHAPES[name]
    args = meta_args(name, *form, **shape)
    fn = getattr(tfab, name)
    before = fn.launches
    kw = {"group": 2} if name == "fused_vit_block_q8" else {}
    out = fn(*args, **kw)
    out = out if isinstance(out, tuple) else (out,)
    assert fn.launches == before + 1
    assert len(out) == (3 if name == "fused_qkv_q8" else 1)
    assert all(o.dtype == form[0] and o.shape == args[0].shape for o in out)
    (launched, ints), = recorded
    assert launched == name
    x_f32, params_f32 = FORMS[form]
    rows, width = 2 * shape["seq"], shape["width"]
    if name == "fused_qkv_q8":
        assert ints == (rows, width, x_f32, params_f32)
    elif name == "fused_mlp_block_q8":
        assert ints == (rows, width, 4 * width, x_f32, params_f32)
    else:
        assert ints == (2, 50, 12, 64, 4 * width, x_f32, params_f32)


@pytest.mark.parametrize("name", KERNELS)
def test_mixed_vectors_are_read_in_fp32(recorded, name):
    """One fp32 bias among bf16 vectors: all are read in fp32 (a bf16 one
    widened, which is exact), the activations' form unchanged."""
    args = list(meta_args(name, BF16, BF16, **META_SHAPES[name]))
    args[5] = args[5].float()            # b_qkv, or b_fc
    kw = {"group": 2} if name == "fused_vit_block_q8" else {}
    getattr(tfab, name)(*args, **kw)
    assert recorded[-1][1][-2:] == (0, 1)


@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_refuses_other_dtypes(recorded, name):
    """float16 activations or a float16 vector, a weight not int8, and
    scales not fp32 raise ValueError before any launch."""
    fn = getattr(tfab, name)
    before = fn.launches
    kw = {"group": 2} if name == "fused_vit_block_q8" else {}
    shape = META_SHAPES[name]
    for act, vec in ((torch.float16, F32), (F32, torch.float16)):
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            fn(*meta_args(name, act, vec, **shape), **kw)
    for index, dtype, match in ((3, BF16, "int8"), (4, BF16, "float32")):
        args = list(meta_args(name, F32, F32, **shape))
        args[index] = args[index].to(dtype)
        with pytest.raises(ValueError, match=match):
            fn(*args, **kw)
    assert fn.launches == before and not recorded


# --- on the CPU: the int8 tower against the JAX package's -------------------

# The tolerances of tests/test_torch_clip_int8.py, on its pinned batch
# (IMAGE_SEED, the weights from seed 4): fp32 activations within TOL (rtol
# and atol) of JAX's embeddings (the same codes on both sides, sums in
# another order); bf16 activations a cosine of at least SAME_PATH_COSINE a
# row (both sides round to bf16 at the same places, JAX's clip_encode_image
# run op by op as the port runs); against the port's unquantized tower of
# the same dtypes a cosine above QUANTIZED_COSINE. In the long branch some
# of the batch's activations lie within an fp32 ulp of a .5 boundary (1.9e-6
# code units with bf16 parameters); the two packages' LayerNorms sum in the
# same order on the CPU, so their codes agree all the same.
TOL = 1e-5
SAME_PATH_COSINE = 0.99999
QUANTIZED_COSINE = 0.995
IMAGE_SEED = 4
BATCH = 2
DTYPES = {"float32": F32, "bfloat16": BF16}
# (activations, parameters)
DTYPE_PAIRS = [("float32", "float32"), ("float32", "bfloat16"),
               ("bfloat16", "float32")]
# small_test's 28-pixel images at patch 14 (5 tokens: one fused_vit_block_q8
# a layer) and patch 2 (197: fused_qkv_q8, attention_core, the
# out-projection, fused_mlp_block_q8)
BRANCHES = {"whole_block": 14, "long": 2}
BRANCH_KERNELS = {"whole_block": ("fused_vit_block_q8",),
                  "long": ("fused_qkv_q8", "attention_core",
                           "fused_mlp_block_q8")}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's CLIP modules (imported here, so that the card's
    machine, which has no jax, still runs this file's gpu tests)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from explicit_alignment_for_vqa_tasks_tpu.models import clip as jclip
    from explicit_alignment_for_vqa_tasks_tpu.tools import (
        clip_encoder as jenc,
    )
    return dict(jax=jax, jnp=jnp, jclip=jclip, jenc=jenc,
                dtypes={"float32": jnp.float32, "bfloat16": jnp.bfloat16})


@pytest.fixture(scope="module")
def fp32_trees():
    """Each branch's fp32 weights drawn once (seed 4) as a numpy tree."""
    return {branch: {key: leaf.numpy() if isinstance(leaf, torch.Tensor)
                     else {k: t.numpy() for k, t in leaf.items()}
                     for key, leaf in tclip.init_clip_vision_params(
                         torch.Generator().manual_seed(4),
                         tclip.CLIPVisionConfig.small_test(patch_size=patch),
                         torch.float32).items()}
            for branch, patch in BRANCHES.items()}


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(IMAGE_SEED).standard_normal(
        (BATCH, 28, 28, 3)).astype(np.float32)


def cosine(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def port_encoder(trees, branch, act, par, int8=True):
    tcfg = tclip.CLIPVisionConfig.small_test(patch_size=BRANCHES[branch],
                                             dtype=DTYPES[act])
    tp = clip_vision_params_from_numpy(trees[branch], DTYPES[par], "cpu")
    return tenc.ClipImageEncoder(tcfg, tp, batch_size=BATCH, int8=int8,
                                 param_dtype=DTYPES[par], device="cpu")


def jax_encoder(jx, trees, branch, act, par):
    jcfg = jx["jclip"].CLIPVisionConfig.small_test(
        patch_size=BRANCHES[branch], dtype=jx["dtypes"][act])
    jp = jx["jax"].tree.map(
        lambda t: jx["jnp"].asarray(t, jx["dtypes"][par]), trees[branch])
    return jx["jenc"].ClipImageEncoder(jcfg, jp, batch_size=BATCH,
                                       int8=True,
                                       param_dtype=jx["dtypes"][par])


@pytest.mark.parametrize("act,par", DTYPE_PAIRS, ids=lambda d: d)
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_int8_tower_matches_jax(jx, fp32_trees, images, branch, act,
                                par):
    """The port's ClipImageEncoder(int8=True) against JAX's
    clip_encode_image on the params and config JAX's ClipImageEncoder(int8=
    True) builds (its blocks_q8), on the same weights in ``par`` and
    activations in ``act``: the embeddings by the tolerances above, no
    kernel launched on the CPU, and the cosine to the port's unquantized
    tower of the same dtypes."""
    encoder = port_encoder(fp32_trees, branch, act, par)
    assert encoder.cfg.int8 and encoder.cfg.dtype == DTYPES[act]
    fns = [getattr(tfab, n) for n in BRANCH_KERNELS[branch]]
    before = [fn.launches for fn in fns]
    got = encoder.encode_batch(images)
    assert [fn.launches for fn in fns] == before
    reference = jax_encoder(jx, fp32_trees, branch, act, par)
    want = np.asarray(jx["jclip"].clip_encode_image(
        reference.params, reference.cfg, jx["jnp"].asarray(images)
    ).astype(jx["jnp"].float32))
    assert got.shape == want.shape == (BATCH, 16)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    if act == "float32":
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    else:
        assert (cosine(got, want) >= SAME_PATH_COSINE).all()
    exact = port_encoder(fp32_trees, branch, act, par,
                         int8=False).encode_batch(images)
    assert (cosine(got, exact) > QUANTIZED_COSINE).all()


def test_clip_encode_image_takes_fp32_activations_on_bf16_params(
        fp32_trees, images):
    """clip_encode_image itself (the encoder's call) on the int8 long
    branch with fp32 activations and bf16 parameters: the fp32 output the
    encoder returns, and the params' dtypes as given (blocks_q8 int8 codes
    and fp32 scales)."""
    encoder = port_encoder(fp32_trees, "long", "float32", "bfloat16")
    params = encoder.params
    assert params["blocks"]["ln1_scale"].dtype == BF16
    assert params["blocks_q8"]["qkv"].dtype == I8
    assert params["blocks_q8"]["qkv_scale"].dtype == F32
    out = tclip.clip_encode_image(params, encoder.cfg,
                                  torch.from_numpy(images))
    assert out.dtype == F32
    np.testing.assert_array_equal(out.numpy(), encoder.encode_batch(images))


# --- on the card: each form against its plain version -----------------------

# (images, tokens, width, heads): ViT-L/14@336's widths at its 577 tokens
# and at 197, ViT-B/32's at its 50
CUDA_SHAPES = {"L577": (2, 577, 1024, 16), "L197": (3, 197, 1024, 16),
               "B50": (8, 50, 768, 12)}
# the forms other than the bf16 one (tests/test_torch_vit_q8_kernels.py)
CUDA_FORMS = {"f32": (F32, F32), "f32_x_bf16_params": (F32, BF16),
              "bf16_x_f32_params": (BF16, F32)}
# rows 13 and 14 as rows 2 and 4 fp32 are held: bit-equal to the plain
# version on rows whose LayerNorm is exact in any order
# (test_cuda_form_equals_plain_on_exact_norm_rows; chip_smoke holds them at
# B=256 within a relative Frobenius error of 1e-4); on random rows at most
# F32_CODES_OFF of the activation codes off the plain version's on the card
# (the .5-boundary flips of the two LayerNorms' sum orders, and what a flip
# moves downstream), every output of a row whose codes all agree with the
# plain version's within F32_TOL (1 + |want|), and the relative Frobenius
# error over all rows at most F32_REL_FROBENIUS. One flipped code of a
# 4096-wide hidden row moves that row's output by about 1e-3 of its norm,
# so on 2 or 3 images that error reads 2e-5 to 1.5e-4 (an H100), above the
# 1e-4 that chip_smoke holds on 256 images; the plain version's output
# rounded to bf16 reads about 1.7e-3 against itself.
F32_CODES_OFF = 1e-4
F32_TOL = 1e-5
F32_REL_FROBENIUS = 3e-4
# bf16 outputs (the bf16 forms' rule, tests/test_torch_vit_q8_kernels.py):
# within BF16_ELEMENT_TOL (|want| + rms(want)) and a relative Frobenius
# error of at most BF16_REL_FROBENIUS
BF16_ELEMENT_TOL = 1.6e-2
BF16_REL_FROBENIUS = 2e-3
# row 12 with fp32 x (block_q8_rule). Its bf16 attention and the codes
# after it flip against the plain version's on the card, so the whole
# block's relative Frobenius error reads 1.2e-4 to 2.2e-3 (an H100), as
# much as the plain output's rounding to bf16 moves it (about 1.7e-3): no
# limit on it alone separates a form that stores its output or r1 in bf16.
# So the rule holds each half of the block against the plain version on the
# kernel's own stages (stages_out: its fp32 attention output and r1): r1
# within F32_TOL (1 + |want|) of x plus the plain out-projection of the
# kernel's attention output (the same codes, the same fp32 epilogue; it
# reads 0 there); the output within F32_REL_FROBENIUS of the plain MLP over
# the kernel's r1 (the rows 14 rule; 4e-8 to 1.8e-4 read there); and the
# whole block's error at most BLOCK_VS_BF16 of the plain version's bf16
# form's (x rounded to bf16 in, the output rounded; the kernel's reads at
# most 0.33 of it), which a form reading x as bf16 (about 0.9 of it) fails.
BLOCK_VS_BF16 = 0.5


def cuda_args(name, shape, act, vec, seed=0, device="cuda"):
    """The kernel's arguments at ``shape`` on ``device``, fp32 vectors that no
    bf16 holds: for rows 13 and 14 random weights of scale D^-1/2 (as their
    bf16 forms' gpu tests) quantized by quantize_vision_blocks, LayerNorm
    scales near 1; for row 12 block_layer's (row 7's) layer at the towers'
    init scale, quantized the same way."""
    batch, seq, width, heads = shape
    d_ff = 4 * width
    if name == "fused_vit_block_q8":
        x, layer = block_layer(width, heads, act, vec, F32, batch, seq,
                               device=device, seed=seed)
        q8 = {n: t[0] for n, t in tclip.quantize_vision_blocks(
            {"blocks": {n: layer[n][None] for n in (
                "q", "k", "v", "o", "mlp_fc", "mlp_proj")}}).items()}
        b_qkv = torch.cat([layer[n + "_bias"] for n in "qkv"])
        return (x, layer["ln1_scale"], layer["ln1_bias"], q8["qkv"],
                q8["qkv_scale"], b_qkv, q8["o"], q8["o_scale"],
                layer["o_bias"], layer["ln2_scale"], layer["ln2_bias"],
                q8["mlp_fc"], q8["mlp_fc_scale"], layer["mlp_fc_bias"],
                q8["mlp_proj"], q8["mlp_proj_scale"], layer["mlp_proj_bias"],
                heads)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(s, generator=gen, device="cuda") * scale

    shapes = {"q": (width, width), "k": (width, width), "v": (width, width),
              "o": (width, width), "mlp_fc": (width, d_ff),
              "mlp_proj": (d_ff, width)}
    q8 = tclip.quantize_vision_blocks({"blocks": {
        n: randn(1, *s, scale=s[0] ** -0.5) for n, s in shapes.items()}})
    q8 = {n: t[0] for n, t in q8.items()}
    x = randn(batch, seq, width).to(act)
    ln = ((1 + randn(width, scale=0.1)).to(vec),
          randn(width, scale=0.1).to(vec))
    if name == "fused_qkv_q8":
        return (x, *ln, q8["qkv"], q8["qkv_scale"],
                randn(3 * width, scale=0.1).to(vec), (width // heads) ** -0.5)
    return (x, *ln, q8["mlp_fc"], q8["mlp_fc_scale"],
            randn(d_ff, scale=0.1).to(vec), q8["mlp_proj"],
            q8["mlp_proj_scale"], randn(width, scale=0.1).to(vec))


def rel_frobenius(got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def block_q8_r1(args, attn):
    """x + the out-projection of ``attn`` (B, L, D), in fp32 as the plain
    version computes r1."""
    x, wo, so, bo = args[0], *args[6:9]
    width = x.shape[-1]
    y = tfab._mm_q8_grouped(
        [tfab._row_quant_i8(attn.reshape(-1, width).float())], wo,
        tfab._as_group_scales(so)) + bo.float()
    return (x.reshape(-1, width).float() + y).reshape(x.shape)


def block_q8_rule(args, got, stages, want, plain_bf16_form):
    """(held, figures): fused_vit_block_q8's fp32 rule (see BLOCK_VS_BF16)
    on its output ``got`` and ``stages`` ({"attn", "r1"}), ``want`` the
    plain version's output and ``plain_bf16_form`` the plain version's on
    x rounded to bf16."""
    r1_want = block_q8_r1(args, stages["attn"]).double()
    r1_err = ((stages["r1"].double() - r1_want).abs()
              / (1 + r1_want.abs())).max().item()
    mlp = tfab.fused_mlp_block_q8_plain(stages["r1"], *args[9:17])
    figures = dict(r1_err=r1_err, mlp_rel_frobenius=rel_frobenius(got, mlp),
                   rel_frobenius=rel_frobenius(got, want),
                   plain_bf16_form_rel_frobenius=rel_frobenius(
                       plain_bf16_form, want))
    held = dict(r1=r1_err <= F32_TOL,
                mlp=figures["mlp_rel_frobenius"] <= F32_REL_FROBENIUS,
                block=figures["rel_frobenius"] <= BLOCK_VS_BF16
                * figures["plain_bf16_form_rel_frobenius"])
    return held, figures


def block_q8_composed(args, where=None):
    """fused_vit_block_q8_plain's function from the plain versions of its
    stages, with x ("x"), r1 ("r1") or the output ("out") rounded to bf16;
    (output, stages)."""
    args = list(args)
    if where == "x":
        args[0] = bf16(args[0])
    heads = args[17]
    q, k, v = (t.to(BF16) for t in tfab.fused_qkv_q8_plain(
        *args[:6], (args[0].shape[-1] // heads) ** -0.5))
    attn = tfab._softmax_pv_f32(q, k, v, heads, "normalised")
    r1 = block_q8_r1(args, attn)
    if where == "r1":
        r1 = bf16(r1)
    out = tfab.fused_mlp_block_q8_plain(r1, *args[9:17])
    return (bf16(out) if where == "out" else out), dict(attn=attn, r1=r1)


# the part of block_q8_rule that each bf16 rounding fails
MUTANT_FAILS = {"x": "r1", "r1": "r1", "out": "mlp"}


@pytest.mark.parametrize("where", list(MUTANT_FAILS))
def test_block_q8_rule_fails_bf16_roundings(where):
    """fused_vit_block_q8's fp32 rule holds the plain version against
    itself (its stages composed give its output bit for bit) and fails it
    with x, r1 or the output rounded to bf16 (50 tokens, width 128, 2
    heads of 64, 2 images)."""
    args = cuda_args("fused_vit_block_q8", (2, 50, 128, 2), F32, F32,
                     seed=11, device="cpu")
    stages = {}
    want = tfab.fused_vit_block_q8_plain(*args, stages_out=stages)
    composed, composed_stages = block_q8_composed(args)
    torch.testing.assert_close(composed, want, rtol=0, atol=0)
    torch.testing.assert_close(composed_stages, stages, rtol=0, atol=0)
    plain_bf16_form = tfab.fused_vit_block_q8_plain(args[0].to(BF16),
                                                    *args[1:])
    held, figures = block_q8_rule(args, want, stages, want, plain_bf16_form)
    assert all(held.values()), figures
    held, figures = block_q8_rule(args, *block_q8_composed(args, where),
                                  want, plain_bf16_form)
    assert not held[MUTANT_FAILS[where]], figures


def cuda_form_cases():
    for shape in CUDA_SHAPES:
        for form in CUDA_FORMS:
            for name in KERNELS:
                yield pytest.param(name, form, shape,
                                   id=f"{name}-{form}-{shape}")


@pytest.mark.gpu
@pytest.mark.parametrize("name,form,shape", list(cuda_form_cases()))
def test_cuda_form_matches_plain_version(name, form, shape,
                                         record_property):
    """The kernel's form against its plain version run on the card on the
    same inputs: one launch counted, outputs finite and in x's dtype, the
    relative Frobenius error recorded. Rows 13 and 14: at most
    F32_CODES_OFF of their codes off the plain version's, and with fp32 x
    every row whose codes agree within F32_TOL (1 + |want|) and all within
    F32_REL_FROBENIUS; row 12 with fp32 x by block_q8_rule, which fails on
    the same readings its output or its r1 rounded to bf16; bf16 outputs by
    the bf16 forms' rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    act, vec = CUDA_FORMS[form]
    args = cuda_args(name, CUDA_SHAPES[shape], act, vec)
    fn, plain = getattr(tfab, name), getattr(tfab, name + "_plain")
    block = name == "fused_vit_block_q8"
    codes, want_codes, stages = {}, {}, {}
    kw, plain_kw = ((dict(group=1, stages_out=stages), {}) if block else
                    (dict(codes_out=codes), dict(codes_out=want_codes)))
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args, **plain_kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g in got:
        assert g.dtype == act and bool(torch.isfinite(g).all())
    rel = max(rel_frobenius(g, w) for g, w in zip(got, want))
    record_property("rel_frobenius", rel)
    if act == BF16:
        assert rel <= BF16_REL_FROBENIUS, rel
        for g, w in zip(got, want):
            g, w = g.float(), w.float()
            rms = w.square().mean().sqrt()
            assert bool(((g - w).abs()
                         <= BF16_ELEMENT_TOL * (w.abs() + rms)).all())
    elif block:
        plain_bf16_form = plain(args[0].to(BF16), *args[1:])
        held, figures = block_q8_rule(args, got[0], stages, want[0],
                                      plain_bf16_form)
        for key, val in figures.items():
            record_property(key, val)
        record_property("plain_rounded_to_bf16_rel_frobenius",
                        rel_frobenius(bf16(want[0]), want[0]))
        assert all(held.values()), figures
        assert not block_q8_rule(args, bf16(got[0]), stages, want[0],
                                 plain_bf16_form)[0]["mlp"]
        assert not block_q8_rule(args, got[0], dict(stages, r1=bf16(
            stages["r1"])), want[0], plain_bf16_form)[0]["r1"]
    else:
        assert rel <= F32_REL_FROBENIUS, rel
    if block:
        return
    keys = [key for key in want_codes if key.endswith("codes")]
    off = sum(int((codes[key] != want_codes[key]).sum()) for key in keys)
    total = sum(want_codes[key].numel() for key in keys)
    record_property("codes_off_plain", off)
    assert off <= F32_CODES_OFF * total, (off, total)
    if act == F32:
        agree = torch.stack([(codes[key] == want_codes[key]).all(dim=-1)
                             for key in keys]).all(dim=0)
        record_property("rows_with_a_code_off", int((~agree).sum()))
        for g, w in zip(got, want):
            g, w = (t.reshape(agree.numel(), -1)[agree].double()
                    for t in (g, w))
            assert bool(((g - w).abs() <= F32_TOL * (1 + w.abs())).all())


def exact_case(name, rows, act, vec):
    """The kernel's arguments at ViT-L/14@336's widths on ``rows`` rows of
    exact_norm_rows (test_torch_vit_q8_kernels' exact cases: their
    LayerNorm exact in any order), x of act, the vectors of vec (fp32 ones
    that no bf16 holds); and eps."""
    if name == "fused_qkv_q8":
        args, eps = exact_qkv_case(rows, 1024)
        vectors = (1, 2, 5)
    else:
        args, eps = exact_mlp_case(rows, 1024, 4096)
        vectors = (1, 2, 5, 8)
    gen = torch.Generator(device="cuda").manual_seed(1)
    args = list(args)
    args[0] = args[0].to(act)
    for i in vectors:
        if vec == F32:
            args[i] = args[i].float() + 1e-3 * torch.rand(
                args[i].shape, generator=gen, device="cuda")
    return tuple(args), eps


@pytest.mark.gpu
@pytest.mark.parametrize("form", list(CUDA_FORMS))
@pytest.mark.parametrize("name", KERNELS[:2])
@pytest.mark.parametrize("rows", [64, 157])
def test_cuda_form_equals_plain_on_exact_norm_rows(rows, name, form):
    """Rows 13 and 14's forms bit-equal to their plain versions (rtol =
    atol = 0) on rows whose LayerNorm is exact in any order, at ViT-L
    widths (a ragged row tile): the same codes, the same fp32 epilogues;
    one launch counted, the outputs in x's dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    act, vec = CUDA_FORMS[form]
    args, eps = exact_case(name, rows, act, vec)
    fn, plain = getattr(tfab, name), getattr(tfab, name + "_plain")
    before = fn.launches
    got = fn(*args, eps=eps)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args, eps=eps)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == act
        torch.testing.assert_close(g, w, rtol=0, atol=0)
