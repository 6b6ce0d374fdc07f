"""The port's int8 CLIP ViT path at the kernel level: quantize_weight_i8 and
quantize_vision_blocks bit-equal to the JAX package's; attention_core,
fused_qkv_q8 and fused_mlp_block_q8's plain versions against the JAX
package's Pallas kernels (interpret mode on the CPU) in fp32 and bf16; the
wrappers on CPU tensors; and the CUDA kernels against the plain versions on
the card."""

import ctypes

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch import kernels
from explicit_alignment_for_vqa_tasks_tpu_torch.models import clip as tclip
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
    fused_attention_block as tfab,
)
from test_torch_int8_kernels import (  # noqa: E402
    TOL,
    assert_q8_close,
    exact_norm_rows,
    near_boundary,
    nudge_columns,
    nudge_rows,
    settle_clear_of_boundaries,
)
from test_torch_vit_kernels import bf16_ulp_of  # noqa: E402

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# seq 197 = (168 / 12)^2 + 1, the long-sequence tower of the CLIP tests
BATCH, SEQ, WIDTH, HEADS, D_FF = 2, 197, 64, 4, 256
EPS = 1e-5
# attention_core in bf16: within one bf16 ulp of JAX's, at least 99.9 %
# equal; in fp32 within FP32_TOL (|jax| + rms(jax)), plus, with fast_exp,
# what the bf16 roundings of s - max that lie near a boundary may move
MIN_EQUAL = 0.999
FP32_TOL = 1e-5
NEAR_ULPS = 16
QUICK_GELU_SLOPE = 1.1    # the largest |d/dz z sigmoid(1.702 z)|, 1.0998


def jax_fab():
    pytest.importorskip("jax")
    from explicit_alignment_for_vqa_tasks_tpu.ops import (
        fused_attention_block as jfab,
    )
    return jfab


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --- the quantizers ---------------------------------------------------------

def test_quantize_weight_i8_is_bit_equal_to_jax():
    """Random columns, an all-zero column (the 1e-8 floor) and a column of
    exact ties (its scale is 127 / 127 = 1, its values k + 0.5)."""
    jfab = jax_fab()
    w = normal(np.random.default_rng(0), 64, 48, scale=0.1)
    w[:, 3] = 0.0
    w[:, 5] = 0.0
    w[:8, 5] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5]
    want_q, want_s = jfab.quantize_weight_i8(w)
    got_q, got_s = tfab.quantize_weight_i8(torch.from_numpy(w))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    assert got_s[3].item() == np.float32(1e-8) / np.float32(127.0)
    assert got_q[:8, 5].tolist() == [127, 0, 2, 2, 0, -2, 126, -4]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_vision_blocks_is_bit_equal_to_jax(dtype):
    jax = pytest.importorskip("jax")
    from explicit_alignment_for_vqa_tasks_tpu.models import clip as jclip

    cfg = tclip.CLIPVisionConfig.small_test(num_layers=3)
    tp = tclip.init_clip_vision_params(torch.Generator().manual_seed(4), cfg,
                                       TORCH_DTYPES[dtype])
    jp = jax.tree.map(lambda t: np.asarray(t.float().numpy()), tp)
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda a: jax.numpy.asarray(a, "bfloat16"), jp)
    want = jclip.quantize_vision_blocks(jp)
    got = tclip.quantize_vision_blocks(tp)
    assert sorted(got) == sorted(want) == sorted(
        ["qkv", "qkv_scale", "o", "o_scale", "mlp_fc", "mlp_fc_scale",
         "mlp_proj", "mlp_proj_scale"])
    for key, leaf in want.items():
        assert got[key].dtype == (torch.float32 if key.endswith("_scale")
                                  else torch.int8), key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(leaf),
                                      err_msg=key)
    assert tuple(got["qkv"].shape) == (3, cfg.width, 3 * cfg.width)


# --- attention_core ---------------------------------------------------------

def attention_inputs(seed=0, batch=BATCH, seq=SEQ):
    rng = np.random.default_rng(seed)
    return [normal(rng, batch, seq, WIDTH, scale=s) for s in (0.5, 2.0, 1.0)]


def run_attention(fn, qkv, dtype, **kw):
    td = TORCH_DTYPES[dtype]
    out = fn(*(torch.from_numpy(a).to(td) for a in qkv), HEADS, **kw)
    assert out.dtype == td and tuple(out.shape) == qkv[0].shape
    return out.float().numpy()


# XLA's CPU compiler hands the interpret-mode kernel's dots to YNNPACK by
# default (its xla_cpu_experimental_ynn_fusion_type). Those kernels are
# where the reference parts from the Pallas kernel's plain fp32 order: with
# them a few outputs near zero, whose bf16 ulp is far below the sums'
# rounding, sit a full ulp from the port's (2 of 25,216 at seed 0), and
# other YNNPACK fusion settings of the same program put outputs 2 ulps
# apart. Compiled without them the reference runs XLA's own emitters and
# equals the port in every output. fast_exp keeps the default compilation:
# the port's "fast_exp" order follows the default's exponential (XLA keeps
# the fp32 value it rounds to bf16 only for PV).
PLAIN_XLA = {"xla_cpu_experimental_ynn_fusion_type": ""}


def jax_attention_core(args, heads, **kw):
    """The JAX package's attention_core in interpret mode on jax arrays,
    compiled with PLAIN_XLA unless ``fast_exp``."""
    jfab = jax_fab()
    options = None if kw.get("fast_exp") else PLAIN_XLA
    return jfab.attention_core.lower(*args, heads, interpret=True, **kw) \
        .compile(compiler_options=options)(*args)


def jax_attention(qkv, dtype, **kw):
    import jax.numpy as jnp

    jd = getattr(jnp, dtype)
    out = jax_attention_core([jnp.asarray(a, jd) for a in qkv], HEADS, **kw)
    return np.asarray(out.astype(jnp.float32))


def fast_exp_flip_bound(qkv):
    """Per output element, how far fp32 attention with fast_exp may move
    for the bf16 roundings of s - max that lie within NEAR_ULPS fp32 ulps
    (of s and of max, the sums other orders move) of a bf16 midpoint: a
    flip moves that exponential by a bf16 ulp of s - max, relative."""
    q, k, v = (torch.from_numpy(a).reshape(BATCH, SEQ, HEADS, -1)
               .transpose(1, 2) for a in qkv)
    s = (q @ k.transpose(-1, -2)).numpy()
    m = s.max(axis=-1, keepdims=True)
    d = (s - m).astype(np.float32)
    bits = d.view(np.uint32) & np.uint32(0xFFFF0000)
    lower = bits.view(np.float32).astype(np.float64)
    upper = (bits + np.uint32(0x10000)).view(np.float32).astype(np.float64)
    window = NEAR_ULPS * (np.spacing(np.abs(s)) + np.spacing(np.abs(m)))
    near = np.abs(d - (lower + upper) / 2) <= window
    e = np.exp(d.astype(np.float64))
    de = near * e * np.abs(d) * 2.0 ** -7 * 1.01
    vv = v.numpy().astype(np.float64)
    denom = e.sum(-1, keepdims=True)
    o = (e @ vv) / denom
    bound = (de @ np.abs(vv) + np.abs(o) * de.sum(-1, keepdims=True)) / denom
    return bound.transpose(0, 2, 1, 3).reshape(BATCH, SEQ, WIDTH)


@pytest.mark.parametrize("fast_exp", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_core_plain_matches_pallas_kernel(dtype, fast_exp):
    qkv = attention_inputs()
    want = jax_attention(qkv, dtype, fast_exp=fast_exp)
    got = run_attention(tfab.attention_core_plain, qkv, dtype,
                        fast_exp=fast_exp)
    if dtype == "bfloat16":
        assert (np.abs(got - want) <= bf16_ulp_of(want)).all()
        assert (got == want).mean() >= MIN_EQUAL
        return
    bound = fast_exp_flip_bound(qkv) if fast_exp else 0.0
    rms = np.sqrt(np.mean(np.square(want)))
    limit = FP32_TOL * (np.abs(want) + rms) + bound
    assert (np.abs(got - want) <= limit).all(), np.abs(got - want).max()


# The ragged edges of the card's attention kernel (a single key, a key tile
# one past a whole one) at its other head sizes: its tests on the card rest
# on the plain version there.
EDGE_HEADS = 2


@pytest.mark.parametrize("fast_exp", [False, True])
@pytest.mark.parametrize("head_dim", [32, 128])
@pytest.mark.parametrize("seq", [1, 65])
def test_attention_core_plain_matches_pallas_kernel_at_edges(seq, head_dim,
                                                             fast_exp):
    jax_fab()
    import jax.numpy as jnp

    rng = np.random.default_rng(seq + head_dim)
    qkv = [normal(rng, BATCH, seq, EDGE_HEADS * head_dim, scale=s)
           for s in (0.5, 2.0, 1.0)]
    want = np.asarray(jax_attention_core(
        [jnp.asarray(a, jnp.bfloat16) for a in qkv], EDGE_HEADS,
        fast_exp=fast_exp).astype(jnp.float32))
    got = tfab.attention_core_plain(
        *(torch.from_numpy(a).bfloat16() for a in qkv), EDGE_HEADS,
        fast_exp=fast_exp)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    got = got.float().numpy()
    assert (np.abs(got - want) <= bf16_ulp_of(want)).all()
    assert (got == want).mean() >= MIN_EQUAL


def test_fast_exp_is_not_the_fp32_exponential():
    """With fast_exp the exponential's argument is rounded to bf16: in fp32
    the output moves by far more than fp32 noise."""
    qkv = attention_inputs(seed=1)
    fast = run_attention(tfab.attention_core_plain, qkv, "float32",
                         fast_exp=True)
    exact = run_attention(tfab.attention_core_plain, qkv, "float32")
    assert np.abs(fast - exact).max() > 1e-4


@pytest.mark.parametrize("fast_exp", [False, True])
def test_attention_core_short_sequence_with_group_2(fast_exp):
    """B=4 at 50 tokens: JAX's group-2 kernel (the group only tiles the
    TPU grid) and the port's ungrouped call agree within one bf16 ulp."""
    qkv = attention_inputs(seed=5, batch=4, seq=50)
    want = jax_attention(qkv, "bfloat16", group=2, fast_exp=fast_exp)
    got = run_attention(tfab.attention_core, qkv, "bfloat16",
                        fast_exp=fast_exp)
    assert (np.abs(got - want) <= bf16_ulp_of(want)).all()


# --- fused_qkv_q8 and fused_mlp_block_q8 ------------------------------------

# The MLP's inputs have 8 rows an image: its hidden's codes are settled by
# moving whole weight columns' scales, which touch every row, and at 197
# rows an image nearly every column holds a code near a boundary.
MLP_SEQ = 8


def q8_inputs(op, seed=0):
    """numpy inputs: x, LayerNorm params, biases, and int8 weights with
    fp32 scales from the JAX package's quantize_weight_i8."""
    jfab = jax_fab()
    rng = np.random.default_rng(seed)
    d, f = WIDTH, D_FF
    seq = SEQ if op == "fused_qkv_q8" else MLP_SEQ
    inp = dict(x=normal(rng, BATCH, seq, d), ln_s=1 + normal(rng, d, scale=0.1),
               ln_b=normal(rng, d, scale=0.1))
    if op == "fused_qkv_q8":
        w, s = jfab.quantize_weight_i8(normal(rng, d, 3 * d, scale=d ** -0.5))
        inp.update(w=[w], s=[s], b=[normal(rng, 3 * d, scale=0.1)])
    else:
        pairs = [jfab.quantize_weight_i8(normal(rng, k, n, scale=k ** -0.5))
                 for k, n in ((d, f), (f, d))]
        inp.update(w=[w for w, _ in pairs], s=[s for _, s in pairs],
                   b=[normal(rng, f, scale=0.1), normal(rng, d, scale=0.1)])
    return inp


def port_args(op, inp, dtype):
    td = TORCH_DTYPES[dtype]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(td)

    prods = [(torch.from_numpy(w), torch.from_numpy(s), t(b))
             for w, s, b in zip(inp["w"], inp["s"], inp["b"])]
    head = (t(inp["x"]), t(inp["ln_s"]), t(inp["ln_b"]))
    flat = [a for prod in prods for a in prod]
    if op == "fused_qkv_q8":
        return (*head, *flat, (WIDTH // HEADS) ** -0.5)
    return (*head, *flat)


def jax_outputs(op, inp, dtype):
    jfab = jax_fab()
    import jax.numpy as jnp

    jd = getattr(jnp, dtype)
    args = [a for w, s, b in zip(inp["w"], inp["s"], inp["b"])
            for a in (jnp.asarray(w), jnp.asarray(s), jnp.asarray(b, jd))]
    head = [jnp.asarray(inp[k], jd) for k in ("x", "ln_s", "ln_b")]
    if op == "fused_qkv_q8":
        outs = jfab.fused_qkv_q8(*head, *args, scale=(WIDTH // HEADS) ** -0.5,
                                 eps=EPS, interpret=True)
    else:
        outs = (jfab.fused_mlp_block_q8(*head, *args, eps=EPS,
                                        interpret=True),)
    return [np.asarray(o.astype(jnp.float32)) for o in outs]


def port_stages(op, inp, dtype):
    """The port's quantizations on the inputs cast to ``dtype``: [(h,
    scales)] for the LayerNorm output and, for the MLP, the fp32 hidden."""
    args = port_args(op, inp, dtype)
    x, ln_s, ln_b = args[:3]
    h = tfab._ln_f32(x.reshape(-1, WIDTH).float(), ln_s, ln_b, EPS)
    hq, hs = tfab._row_quant_i8(h)
    stages = [(h, hq, hs)]
    if op == "fused_mlp_block_q8":
        w_fc, s_fc, b_fc = args[3:6]
        z = tfab._mm_q8_grouped([(hq, hs)], w_fc, s_fc[None]) + b_fc.float()
        hid = z * torch.sigmoid(tfab.QUICK_GELU_ALPHA * z)
        stages.append((hid, *tfab._row_quant_i8(hid)))
    return stages


def jax_codes(op, inp, dtype):
    """JAX's codes for the port_stages quantizations, from the kernels'
    own helpers under jit (as the Pallas kernels run them)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    jfab = jax_fab()
    jd = getattr(jnp, dtype)

    def stages(x, ln_s, ln_b, w, s, b):
        h = jfab._ln_f32(x.reshape(-1, WIDTH).astype(jnp.float32), ln_s,
                         ln_b, EPS)
        hq, hs = jfab._row_quant_i8(h)
        out = [hq]
        if op == "fused_mlp_block_q8":
            acc = jax.lax.dot_general(hq, w, (((1,), (0,)), ((), ())),
                                      preferred_element_type=jnp.int32)
            z = acc.astype(jnp.float32) * hs * s + b.astype(jnp.float32)
            out.append(jfab._row_quant_i8(z * jax.nn.sigmoid(1.702 * z))[0])
        return out

    out = jax.jit(stages)(
        *(jnp.asarray(inp[k], jd) for k in ("x", "ln_s", "ln_b")),
        jnp.asarray(inp["w"][0]), jnp.asarray(inp["s"][0]),
        jnp.asarray(inp["b"][0], jd))
    return [np.asarray(q) for q in out]


def settled_q8_inputs(op, dtype, seed=0):
    """q8_inputs moved clear of the .5 code boundaries (the int8 T5 tests'
    rule): x where the LayerNorm's codes are near one, the up-product's
    scales where the hidden's are."""
    inp = q8_inputs(op, seed)

    def stage_codes():
        return [(h / hs).numpy() for h, _, hs in port_stages(op, inp, dtype)]

    settle_clear_of_boundaries(
        stage_codes, [lambda near: nudge_rows(inp["x"], near),
                      lambda near: nudge_columns(inp["s"][0], near)])
    return inp


Q8_OPS = ("fused_qkv_q8", "fused_mlp_block_q8")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", Q8_OPS)
def test_q8_plain_matches_pallas_kernel(op, dtype):
    """Inputs clear of the .5 boundaries: the codes of every stage equal
    JAX's, and each output is within the dtype's tolerance of the Pallas
    kernel's."""
    inp = settled_q8_inputs(op, dtype)
    for (_, hq, _), want in zip(port_stages(op, inp, dtype),
                                jax_codes(op, inp, dtype)):
        np.testing.assert_array_equal(hq.numpy(), want)
    want = jax_outputs(op, inp, dtype)
    got = getattr(tfab, op + "_plain")(*port_args(op, inp, dtype), eps=EPS)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == TORCH_DTYPES[dtype]
        assert tuple(g.shape) == inp["x"].shape
        assert_q8_close(g.float().numpy(), w, dtype,
                        np.zeros(g.shape[0] * g.shape[1]))


def q8_row_bounds(op, inp):
    """(rows,) how far each fp32 output row may move for the codes that can
    flip in it (within NEAR_ULPS of a .5 boundary): one flipped code moves
    a product's outputs by at most hs * 127 * max(s); for the MLP that
    bounds z, through quickGELU the hidden, and with a rounding step of
    either side's scale the down product."""
    stages = port_stages(op, inp, "float32")
    h, _, hs = stages[0]
    n1 = near_boundary((h / hs).numpy()).sum(axis=1)
    step1 = hs[:, 0].numpy() * 127 * float(inp["s"][0].max())
    if op == "fused_qkv_q8":
        return n1 * step1
    hid, _, gs = stages[1]
    n2 = near_boundary((hid / gs).numpy()).sum(axis=1)
    s_pr = torch.from_numpy(inp["s"][1])
    bound = n2 * gs[:, 0].numpy() * 127 * float(s_pr.max())
    dhid = QUICK_GELU_SLOPE * torch.from_numpy(
        (n1 * step1).astype(np.float32))[:, None]
    gs_flip = gs + dhid / 127
    w_abs = torch.from_numpy(inp["w"][1]).float().abs() * s_pr
    dy = (dhid.expand_as(hid) + gs + gs_flip) @ w_abs
    return bound + np.where(n1 > 0, dy.amax(dim=1).numpy(), 0.0)


@pytest.mark.parametrize("op", Q8_OPS)
def test_q8_plain_stays_within_the_flip_bound_on_a_boundary(op):
    """One LayerNorm output pinned on a .5 code boundary: the codes may
    differ from JAX's only near a boundary (the hidden's compared in the
    rows whose first codes agree: a flipped one moves the whole hidden
    row), and each output row stays within what its possible flips can
    move it."""
    inp = q8_inputs(op, seed=3)
    flat = inp["x"].reshape(-1, WIDTH)
    for _ in range(20):     # h and its scale move with x: a fixed point
        h, _, hs = port_stages(op, inp, "float32")[0]
        t = (h / hs)[5, 7].item()
        flat[5, 7] *= np.float32((np.floor(abs(t)) + 0.5) * np.sign(t) / t)
    bound = q8_row_bounds(op, inp)
    assert bound[5] > 0
    same_rows = slice(None)
    for (h, hq, hs), want in zip(port_stages(op, inp, "float32"),
                                 jax_codes(op, inp, "float32")):
        differ = hq.numpy() != want
        assert not (differ & ~near_boundary((h / hs).numpy()))[same_rows] \
            .any()
        same_rows = ~differ.any(axis=1)
    want = jax_outputs(op, inp, "float32")
    got = getattr(tfab, op + "_plain")(*port_args(op, inp, "float32"),
                                       eps=EPS)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert_q8_close(g.numpy(), w, "float32", bound)


def test_mlp_hidden_is_not_rounded_to_bf16():
    """The int8 MLP quantizes the fp32 LayerNorm output and the fp32
    hidden: rounding either to bf16 first changes the output."""
    inp = q8_inputs("fused_mlp_block_q8", seed=6)
    args = port_args("fused_mlp_block_q8", inp, "float32")
    got = tfab.fused_mlp_block_q8_plain(*args)
    x, ln_s, ln_b, w_fc, s_fc, b_fc, w_pr, s_pr, b_pr = args
    x32 = x.reshape(-1, WIDTH)
    h = tfab._ln_f32(x32, ln_s, ln_b, EPS).bfloat16().float()
    z = tfab._mm_q8_grouped([tfab._row_quant_i8(h)], w_fc, s_fc[None]) + b_fc
    hid = (z * torch.sigmoid(1.702 * z)).bfloat16().float()
    y = tfab._mm_q8_grouped([tfab._row_quant_i8(hid)], w_pr, s_pr[None])
    rounded = (x32 + (y + b_pr)).reshape(x.shape)
    assert (got - rounded).abs().max().item() > 1e-4


# --- the wrappers on the CPU ------------------------------------------------

WRAPPED = ("attention_core", "fused_qkv_q8", "fused_mlp_block_q8")


def wrapper_args(name, seed):
    if name == "attention_core":
        return (*(torch.from_numpy(a).bfloat16()
                  for a in attention_inputs(seed)), HEADS)
    return port_args(name, q8_inputs(name, seed), "bfloat16")


@pytest.mark.parametrize("name", WRAPPED)
def test_wrapper_takes_plain_version_on_cpu(name):
    args = wrapper_args(name, seed=1)
    fn = getattr(tfab, name)
    before = fn.launches
    got = fn(*args)
    want = getattr(tfab, name + "_plain")(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert fn.launches == before


@pytest.mark.parametrize("op", Q8_OPS)
def test_codes_out_holds_the_plain_quantizations(op):
    """codes_out, through the wrapper on CPU tensors: the LayerNorm's codes
    and row scales, and for the MLP the hidden's, as port_stages computes
    them."""
    inp = q8_inputs(op, seed=2)
    codes_out = {}
    getattr(tfab, op)(*port_args(op, inp, "bfloat16"), eps=EPS,
                      codes_out=codes_out)
    stages = port_stages(op, inp, "bfloat16")
    prefixes = ["", "hidden_"][:len(stages)]
    assert sorted(codes_out) == sorted(p + k for p in prefixes
                                       for k in ("codes", "scales"))
    for prefix, (_, hq, hs) in zip(prefixes, stages):
        assert torch.equal(codes_out[prefix + "codes"], hq)
        assert torch.equal(codes_out[prefix + "scales"], hs)


def test_library_paths_cover_the_int8_header():
    names = {name: [p.name for p in kernels.included_files(name)]
             for name in ("int8_encoder", "vit_block_q8")}
    assert names == {"int8_encoder": ["int8_encoder.cu", "activations.cuh",
                                      "q8_gemm.cuh", "q8_gemm_tma.cuh",
                                      "hopper_async.cuh"],
                     "vit_block_q8": ["vit_block_q8.cu", "activations.cuh",
                                      "forms.cuh", "q8_gemm.cuh",
                                      "q8_gemm_tma.cuh", "vit_attention.cuh",
                                      "hopper_async.cuh"]}
    assert kernels.library_path("vit_block_q8").name.startswith(
        "vit_block_q8-")


# --- on the card: the CUDA kernels against the plain versions --------------

EDGE_LENGTHS = (1, 50, 64, 65, 577, 1025)
EDGE_HEAD_DIMS = (16, 32, 64, 128)
EDGE_WIDTH = 256                  # 16 heads of 16 ... 2 of 128

def cuda_case(name):
    """ViT-L/14@336 widths (L 577, D 1024, 16 heads, F 4096) on 2 images,
    bf16, one layer's weights from quantize_vision_blocks."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).bfloat16()

    batch, seq, width, heads, d_ff = 2, 577, 1024, 16, 4096
    if name.startswith("attention_core"):
        return (*(randn(batch, seq, width, scale=s) for s in (0.5, 2.0, 1.0)),
                heads)
    shapes = {"q": (width, width), "k": (width, width), "v": (width, width),
              "o": (width, width), "mlp_fc": (width, d_ff),
              "mlp_proj": (d_ff, width)}
    q8 = tclip.quantize_vision_blocks({"blocks": {
        n: randn(1, *s, scale=s[0] ** -0.5) for n, s in shapes.items()}})
    x = randn(batch, seq, width)
    ln = (1 + randn(width, scale=0.1), randn(width, scale=0.1))
    if name == "fused_qkv_q8":
        return (x, *ln, q8["qkv"][0], q8["qkv_scale"][0],
                randn(3 * width, scale=0.1), (width // heads) ** -0.5)
    return (x, *ln, q8["mlp_fc"][0], q8["mlp_fc_scale"][0],
            randn(d_ff, scale=0.1), q8["mlp_proj"][0],
            q8["mlp_proj_scale"][0], randn(width, scale=0.1))


@pytest.mark.gpu
@pytest.mark.parametrize("name", WRAPPED + ("attention_core_fast_exp",))
def test_cuda_kernel_matches_plain_version(name):
    """The kernel against its plain version: attention within 8e-3 (1 +
    |want|); the int8 kernels within 1.6e-2 (|want| + rms(want)) with a
    relative Frobenius error of at most 2e-3 (a rare flipped code); one
    launch counted. fp32 inputs take each kernel's fp32 form: one launch
    counted, fp32 outputs (tests/test_torch_vit_f32_kernels.py and
    tests/test_torch_vit_q8_f32.py hold their values)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = cuda_case(name)
    kw = {"fast_exp": True} if name.endswith("fast_exp") else {}
    base = name.replace("_fast_exp", "")
    fn, plain = getattr(tfab, base), getattr(tfab, base + "_plain")
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, p in zip(got, want):
        g, p = g.float(), p.float()
        if base == "attention_core":
            assert bool(((g - p).abs() <= 8e-3 * (1 + p.abs())).all())
            continue
        rel = ((g - p).norm() / p.norm()).item()
        assert rel <= 2e-3, rel
        rms = p.square().mean().sqrt()
        assert bool(((g - p).abs() <= 1.6e-2 * (p.abs() + rms)).all())
    n_acts = 3 if base == "attention_core" else 1
    before = fn.launches
    out = fn(*(a.float() for a in args[:n_acts]), *args[n_acts:], **kw)
    torch.cuda.synchronize()
    out = out if isinstance(out, tuple) else (out,)
    assert fn.launches == before + 1
    assert all(o.dtype == torch.float32 for o in out)


def exact_mlp_case(rows: int, d_model: int, d_ff: int, seed: int = 0):
    """fused_mlp_block_q8's arguments on rows of exact_norm_rows (whose
    LayerNorm is exact in any order), bf16, weights from the port's
    quantize_weight_i8, random LayerNorm parameters and biases; and eps."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x, eps = exact_norm_rows(gen, rows, d_model)
    fc = tfab.quantize_weight_i8(randn(d_model, d_ff, scale=d_model ** -0.5))
    proj = tfab.quantize_weight_i8(randn(d_ff, d_model, scale=d_ff ** -0.5))
    return (x[None].bfloat16(), (1 + randn(d_model, scale=0.1)).bfloat16(),
            randn(d_model, scale=0.1).bfloat16(), *fc,
            randn(d_ff, scale=0.1).bfloat16(), *proj,
            randn(d_model, scale=0.1).bfloat16()), eps


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,d_ff", [(1024, 4096), (256, 640)])
@pytest.mark.parametrize("rows", [64, 157])
def test_cuda_mlp_q8_equals_plain(rows, d_model, d_ff):
    """fused_mlp_block_q8 bit-equal to its plain version (rtol = atol = 0)
    on inputs whose LayerNorm is exact in any order: a ragged row tile, and
    ViT-L's F = 4096 (the up-product in 128 x 256 tiles) or an F that is a
    multiple of 128 but not of 256 (128 x 128 tiles, the down-product's
    contraction 5 k steps of 128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, eps = exact_mlp_case(rows, d_model, d_ff)
    before = tfab.fused_mlp_block_q8.launches
    got = tfab.fused_mlp_block_q8(*args, eps=eps)
    torch.cuda.synchronize()
    assert tfab.fused_mlp_block_q8.launches == before + 1
    want = tfab.fused_mlp_block_q8_plain(*args, eps=eps)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def exact_qkv_case(rows: int, d_model: int, seed: int = 0):
    """fused_qkv_q8's arguments on rows of exact_norm_rows (whose LayerNorm
    is exact in any order), bf16, the weight from the port's
    quantize_weight_i8, random LayerNorm parameters and biases, 64-wide
    heads' q scale; and eps."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x, eps = exact_norm_rows(gen, rows, d_model)
    qkv = tfab.quantize_weight_i8(randn(d_model, 3 * d_model,
                                        scale=d_model ** -0.5))
    return (x[None].bfloat16(), (1 + randn(d_model, scale=0.1)).bfloat16(),
            randn(d_model, scale=0.1).bfloat16(), *qkv,
            randn(3 * d_model, scale=0.1).bfloat16(), 64 ** -0.5), eps


@pytest.mark.gpu
@pytest.mark.parametrize("d_model", [1024, 640])
@pytest.mark.parametrize("rows", [64, 157])
def test_cuda_qkv_q8_equals_plain(rows, d_model):
    """fused_qkv_q8 bit-equal to its plain version (rtol = atol = 0) on
    inputs whose LayerNorm is exact in any order: a ragged row tile, and
    ViT-L's D = 1024 (3 D in 128 x 256 tiles) or D = 640 (3 D not a
    multiple of 256: 128 x 128 tiles), each column tile routed into q, k or
    v."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, eps = exact_qkv_case(rows, d_model)
    before = tfab.fused_qkv_q8.launches
    got = tfab.fused_qkv_q8(*args, eps=eps)
    torch.cuda.synchronize()
    assert tfab.fused_qkv_q8.launches == before + 1
    want = tfab.fused_qkv_q8_plain(*args, eps=eps)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.gpu
def test_cuda_quick_gelu_epilogue_is_exact_for_every_float():
    """The ViT up-GEMMs' quickGELU epilogues (the sigmoid's reciprocal as
    an estimate and two FMA Newton steps; the int8 one computes the rare
    case out of that range again, the bf16 one takes the division below
    a floor) equal quick_gelu's correctly rounded division for every one
    of the 2^32 floats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fn = kernels.load("vit_block_q8").quick_gelu_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    differ = torch.zeros(1, dtype=torch.int64, device="cuda")
    assert fn(differ.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert differ.item() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["attention_core", "attention_core_fast_exp",
                                  "attention_core_oproj"])
@pytest.mark.parametrize("head_dim", EDGE_HEAD_DIMS)
@pytest.mark.parametrize("seq", EDGE_LENGTHS)
def test_cuda_attention_core_sweep(seq, head_dim, name):
    """The wgmma attention of attention_core (both orders) and
    attention_core_oproj on 2 images at every head size and at lengths
    with a single key, a ragged query and key tile, a TMA box past L and a
    length beyond the old kernel's shared-memory limit: every element
    within 8e-3 (1 + |want|) of the plain version, one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(seq + head_dim)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).bfloat16()

    heads = EDGE_WIDTH // head_dim
    q, k, v = (randn(2, seq, EDGE_WIDTH, scale=s) for s in (0.5, 2.0, 1.0))
    if name == "attention_core_oproj":
        args = (randn(2, seq, EDGE_WIDTH), q, k, v,
                randn(EDGE_WIDTH, EDGE_WIDTH, scale=EDGE_WIDTH ** -0.5),
                randn(EDGE_WIDTH, scale=0.1), heads)
        kw = {}
    else:
        args = (q, k, v, heads)
        kw = {"fast_exp": True} if name.endswith("fast_exp") else {}
    base = name.replace("_fast_exp", "")
    fn, plain = getattr(tfab, base), getattr(tfab, base + "_plain")
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    got, want = got.float(), plain(*args, **kw).float()
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= 8e-3 * (1 + want.abs())).all()), \
        (got - want).abs().max().item()
