"""The fp32 forms of the CLIP ViT split3 kernels (fused_ln_qkv,
attention_core_oproj, fused_mlp_block) and of attention_core: fp32
activations, or bf16 ones with fp32 LayerNorms and biases. On the CPU: the
wrappers' dtype rules and the form each CUDA call launches (a recording
launcher on meta tensors), and the rules that hold the fp32 forms on the
card failing every form that rounds x, q / k / v, the attention output or
the result to bf16 (mutants of the plain versions). (The int8 kernels'
fp32 forms are tests/test_torch_vit_q8_f32.py's.) On the card: each
form against its plain version, the mixed forms bit-equal to the bf16
forms on bf16-valued parameters, and the held route's limit."""

import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch import kernels
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
    fused_attention_block as tfab,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import kernel_probe

F32, BF16 = torch.float32, torch.bfloat16
KERNELS = ("fused_ln_qkv", "attention_core_oproj", "fused_mlp_block",
           "attention_core")
# attention_core and attention_core_oproj in fp32: every output within
# F32_TOL (1 + |want|) of the plain version. With fast_exp, where two sum
# orders may round an exponential's argument to bf16 the other way: every
# output within that plus fast_exp_flip_bound, and at least MIN_CLOSE_FAST
# of them within F32_TOL (1 + |want|). fused_ln_qkv and fused_mlp_block
# round h and hid to bf16, where the same holds: a relative Frobenius error
# of at most REL_FROBENIUS and at least MIN_CLOSE of the outputs within
# F32_TOL (1 + |want|). A form that rounds anything fp32 to bf16 misses
# every rule by far (test_f32_rule_fails_bf16_roundings).
F32_TOL = 1e-5
REL_FROBENIUS = 1e-4
MIN_CLOSE = 0.2
MIN_CLOSE_FAST = 0.95
# the bf16 forms' rule (tests/test_torch_vit_kernels.py): within 8e-3
# (1 + |want|)
BF16_TOL = 8e-3


def fast_exp_flip_bound(q, k, v, heads):
    """Per output element, how far fp32 attention with fast_exp may move
    for the bf16 roundings of s - max that two fp32 evaluations of the
    scores may take apart: those within the error bound of two fp32 dots
    of dh terms (2 dh 2^-24 sum |q_i k_i|) of s, the same of the row's
    max, and the subtraction's roundings, of a bf16 midpoint. A flip moves
    the argument by at most a bf16 ulp of s - max (2^-7 |s - max|), its
    exponential e by e expm1 of that."""
    batch, seq, width = q.shape
    dh = width // heads

    def h(t):
        return t.double().reshape(batch, seq, heads, dh).transpose(1, 2)

    qh, kh, vh = h(q), h(k), h(v)
    s = (qh @ kh.transpose(-1, -2)).float()
    err = 2 * dh * 2.0 ** -24 * (qh.abs() @ kh.abs().transpose(-1, -2))
    d = (s - s.amax(dim=-1, keepdim=True)).contiguous()
    ulp = torch.nextafter(d.abs(), torch.full_like(d, float("inf"))) \
        - d.abs()
    err = err + err.amax(dim=-1, keepdim=True) + 2 * ulp.double()
    bits = d.view(torch.int32) & -65536
    lower = bits.view(torch.float32).double()
    upper = (bits + 65536).view(torch.float32).double()
    dd = d.double()
    near = (dd - (lower + upper) / 2).abs() <= err
    e = torch.exp(dd)
    de = near * e * torch.expm1(dd.abs() * 2.0 ** -7)
    denom = e.sum(dim=-1, keepdim=True)
    o = (e @ vh) / denom
    bound = (de @ vh.abs() + o.abs() * de.sum(dim=-1, keepdim=True)) / denom
    return bound.transpose(1, 2).reshape(batch, seq, width)


def f32_rule(name, got, want, flip_bound=None):
    """(held, figures) of an fp32 form's output against its plain
    version's, by the rule of the function (see F32_TOL); ``flip_bound``
    (fast_exp_flip_bound) for attention with fast_exp."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    limit = F32_TOL * (1 + want.abs())
    figures = dict(max_abs_err=err.max().item(),
                   close_share=(err <= limit).double().mean().item())
    if name in ("fused_ln_qkv", "fused_mlp_block"):
        figures["rel_frobenius"] = ((got - want).norm() / want.norm()).item()
        return (figures["rel_frobenius"] <= REL_FROBENIUS
                and figures["close_share"] >= MIN_CLOSE), figures
    if flip_bound is None:
        return figures["close_share"] == 1.0, figures
    return (bool((err <= limit + flip_bound).all())
            and figures["close_share"] >= MIN_CLOSE_FAST), figures


def vit_inputs(batch, seq, width, heads, act, vec, mat, device, seed=0):
    """Every operand of the four kernels at (B, L, D = width, F = 4 D):
    activations of dtype act, vectors of vec, weights of mat (fp32 weights
    not bf16-valued); LayerNorm scales near 1, weights of scale D^-1/2,
    pre-scaled q, k, v of scales 0.5, 2 and 1."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    d_ff = 4 * width
    return dict(
        x=randn(batch, seq, width).to(act),
        ln_s=(1 + randn(width, scale=0.1)).to(vec),
        ln_b=randn(width, scale=0.1).to(vec),
        w=[randn(width, width, scale=width ** -0.5).to(mat)
           for _ in range(4)],
        b=[randn(width, scale=0.1).to(vec) for _ in range(4)],
        w_fc=randn(width, d_ff, scale=width ** -0.5).to(mat),
        b_fc=randn(d_ff, scale=0.1).to(vec),
        w_proj=randn(d_ff, width, scale=d_ff ** -0.5).to(mat),
        b_proj=randn(width, scale=0.1).to(vec),
        qkv=[randn(batch, seq, width, scale=s).to(act)
             for s in (0.5, 2.0, 1.0)],
        heads=heads)


def kernel_args(name, inp):
    """The wrapper's positional arguments of kernel ``name``."""
    if name == "fused_ln_qkv":
        w, b = inp["w"], inp["b"]
        return (inp["x"], inp["ln_s"], inp["ln_b"], w[0], b[0], w[1], b[1],
                w[2], b[2], (inp["x"].shape[-1] // inp["heads"]) ** -0.5)
    if name == "attention_core_oproj":
        return (inp["x"], *inp["qkv"], inp["w"][3], inp["b"][3],
                inp["heads"])
    if name == "attention_core":
        return (*inp["qkv"], inp["heads"])
    return (inp["x"], inp["ln_s"], inp["ln_b"], inp["w_fc"], inp["b_fc"],
            inp["w_proj"], inp["b_proj"])


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


# --- on the CPU: the rules fail forms that round to bf16 -------------------

def bf16(t):
    return t.to(BF16).to(t.dtype)


def mutant(name, args, where):
    """The plain version of ``name`` with one fp32 value rounded to bf16:
    ``where`` is "x" (x, or q, k, v of attention_core), "qkv" (the
    attention's q, k, v), "attention" (attention_core_oproj's attention
    output) or "out" (every output)."""
    plain = getattr(tfab, name + "_plain")
    args = list(args)
    if where == "x":
        args[0] = bf16(args[0])
        if name == "attention_core":
            args[1], args[2] = bf16(args[1]), bf16(args[2])
    if where == "qkv":
        args[1:4] = [bf16(t) for t in args[1:4]]
    if where == "attention":
        residual, q, k, v, wo, bo, heads = args
        o = bf16(tfab.attention_core_plain(q, k, v, heads))
        y = o @ wo.to(BF16).float() + bo.float()
        return (residual + y,)
    out = as_tuple(plain(*args))
    return tuple(bf16(t) for t in out) if where == "out" else out


MUTANTS = [("fused_ln_qkv", "x"), ("fused_ln_qkv", "out"),
           ("fused_mlp_block", "x"), ("fused_mlp_block", "out"),
           ("attention_core", "x"), ("attention_core", "out"),
           ("attention_core_oproj", "x"), ("attention_core_oproj", "qkv"),
           ("attention_core_oproj", "attention"),
           ("attention_core_oproj", "out")]


@pytest.mark.parametrize("name,where", MUTANTS)
def test_f32_rule_fails_bf16_roundings(name, where):
    """On the plain versions' fp32 outputs at a small ViT shape (65 tokens,
    2 heads of 64): the fp32 rule holds the plain version against itself
    and fails it with x, q / k / v, the attention output or the result
    rounded to bf16."""
    inp = vit_inputs(2, 65, 128, 2, F32, F32, F32, "cpu", seed=3)
    args = kernel_args(name, inp)
    want = as_tuple(getattr(tfab, name + "_plain")(*args))
    got = mutant(name, args, where)
    assert all(f32_rule(name, w, w)[0] for w in want)
    assert not all(f32_rule(name, g, w)[0] for g, w in zip(got, want)), \
        [f32_rule(name, g, w)[1] for g, w in zip(got, want)]


def fast_exp_in_other_order(q, k, v, heads):
    """attention_core's fast_exp order with the scores rounded once from
    fp64 (another valid fp32 evaluation of them) and P . V in fp64."""
    batch, seq, width = q.shape

    def h(t):
        return t.double().reshape(batch, seq, heads, -1).transpose(1, 2)

    s = (h(q) @ h(k).transpose(-1, -2)).float()
    e = torch.exp((s - s.amax(dim=-1, keepdim=True)).to(BF16).float())
    o = (e.double() @ h(v)) / e.double().sum(dim=-1, keepdim=True)
    return o.transpose(1, 2).reshape(batch, seq, width).float()


@pytest.mark.parametrize("seed", range(3))
def test_fast_exp_rule_holds_another_order_and_fails_bf16(seed):
    """The fast_exp rule holds the plain version against fast_exp computed
    from differently rounded scores (exponentials' arguments that round to
    bf16 the other way included) and fails it rounded to bf16."""
    q, k, v = vit_inputs(2, 65, 128, 2, F32, F32, F32, "cpu",
                         seed=seed)["qkv"]
    want = tfab.attention_core_plain(q, k, v, 2, fast_exp=True)
    bound = fast_exp_flip_bound(q, k, v, 2)
    other = fast_exp_in_other_order(q, k, v, 2)
    held, figures = f32_rule("attention_core", other, want, bound)
    assert held, figures
    assert not f32_rule("attention_core", bf16(want), want, bound)[0]


# --- on the CPU: the wrappers' dtype rules and forms ------------------------

@pytest.fixture
def recorded(monkeypatch):
    """The CUDA wrappers' launchers replaced by one that records each
    call's integer arguments (and launches nothing), and a stub stream:
    meta tensors then take the CUDA path up to the launch."""
    calls = []

    def launcher_of(lib, name, n_ptrs, n_ints, n_floats):
        def launch(*args):
            assert len(args) == n_ptrs + n_ints + n_floats + 1
            calls.append((name, args[n_ptrs:n_ptrs + n_ints]))
            return 0
        return launch

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(tfab, "_launcher_of", launcher_of)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    return calls


def meta_inputs(act, vec, mat, batch=2, seq=577, width=1024, heads=16):
    """vit_inputs' shapes and dtypes as meta tensors (no data)."""
    d_ff = 4 * width

    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    vecs = (width,)
    return dict(
        x=t((batch, seq, width), act), ln_s=t(vecs, vec), ln_b=t(vecs, vec),
        w=[t((width, width), mat) for _ in range(4)],
        b=[t(vecs, vec) for _ in range(4)],
        w_fc=t((width, d_ff), mat), b_fc=t((d_ff,), vec),
        w_proj=t((d_ff, width), mat), b_proj=t(vecs, vec),
        qkv=[t((batch, seq, width), act) for _ in range(3)], heads=heads)


# (activations, vectors, weights) -> (x_f32, params_f32) of the launch
FORMS = {(BF16, BF16, BF16): (0, 0), (BF16, F32, F32): (0, 1),
         (BF16, F32, BF16): (0, 1), (F32, BF16, BF16): (1, 0),
         (F32, BF16, F32): (1, 0), (F32, F32, F32): (1, 1)}


@pytest.mark.parametrize("form", list(FORMS), ids=lambda f: "-".join(
    str(t).removeprefix("torch.") for t in f))
@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_launches_the_form_of_its_dtypes(recorded, name, form):
    """One launch counted, with the form's x_f32 and params_f32 flags (the
    fp32 attention's route at 577 tokens the held one with K in the score
    rows; the bf16 kernels ignore the route); the outputs in x's dtype."""
    inp = meta_inputs(*form)
    fn = getattr(tfab, name)
    before = fn.launches
    out = as_tuple(fn(*kernel_args(name, inp)))
    assert fn.launches == before + 1
    assert all(o.dtype == form[0] for o in out)
    (launched, ints), = recorded
    assert launched == name
    x_f32, params_f32 = FORMS[form]
    route = tfab.F32_HELD_KS if x_f32 else tfab.F32_TWO_PASS
    if name == "fused_ln_qkv":
        assert ints == (2 * 577, 1024, x_f32, params_f32)
    elif name == "fused_mlp_block":
        assert ints == (2 * 577, 1024, 4096, x_f32, params_f32)
    elif name == "attention_core_oproj":
        assert ints == (2, 577, 16, 64, x_f32, params_f32, route)
    else:
        assert ints == (2, 577, 16, 64, 0, x_f32, route)


# (tokens, head size, the route)
ROUTES = [(50, 64, tfab.F32_HELD), (197, 64, tfab.F32_HELD),
          (576, 64, tfab.F32_HELD), (577, 64, tfab.F32_HELD_KS),
          (640, 64, tfab.F32_HELD_KS), (641, 64, tfab.F32_TWO_PASS),
          (50, 128, tfab.F32_HELD), (256, 128, tfab.F32_HELD),
          (257, 128, tfab.F32_TWO_PASS), (641, 128, tfab.F32_TWO_PASS)]


@pytest.mark.parametrize("name,seq,head_dim,route,fast_exp", [
    (name, seq, head_dim, route, fast_exp)
    for name in ("attention_core", "attention_core_oproj")
    for seq, head_dim, route in ROUTES
    for fast_exp in ((False, True) if name == "attention_core" else (False,))
])
def test_f32_attention_route_by_length(recorded, name, seq, head_dim, route,
                                       fast_exp):
    """The fp32 attention's route by L and the head size alone: the held
    route up to 576 tokens at head size 64 and 256 at 128 (its score rows
    fit a block's shared memory), at 64 the held route with K in the score
    rows up to 640, two passes past that; fast_exp passed through and not
    read by the route."""
    inp = meta_inputs(F32, F32, F32, seq=seq, width=16 * head_dim)
    kw = {"fast_exp": fast_exp} if name == "attention_core" else {}
    getattr(tfab, name)(*kernel_args(name, inp), **kw)
    ints = recorded[-1][1]
    assert ints[3] == head_dim
    assert ints[-1] == route == tfab.vit_f32_route(seq, head_dim)
    if name == "attention_core":
        assert ints[4:6] == (int(fast_exp), 1)


def test_held_route_limits_mirror_the_header():
    """The limits of the header's held_smem_bytes and held_ks_smem_bytes
    (with the 1,024 bytes that align E·V's bf16 planes) against the card's
    232,448 bytes a block."""
    assert tfab.f32_attention_held(576, 64)
    assert not tfab.f32_attention_held(577, 64)
    assert tfab.f32_attention_held(256, 128)
    assert not tfab.f32_attention_held(257, 128)
    assert tfab.f32_held_ks_smem_bytes(577) == 232448
    assert tfab.f32_held_ks_smem_bytes(640) == 232448
    assert tfab.f32_held_ks_smem_bytes(641) > 232448
    assert tfab.vit_f32_route(300, 128) == tfab.F32_TWO_PASS


def test_mixed_vectors_are_read_in_fp32(recorded):
    """One fp32 vector among bf16 ones: all are read in fp32 (a bf16 one
    widened, which is exact)."""
    inp = meta_inputs(F32, BF16, BF16)
    inp["b"][1] = torch.empty(inp["b"][1].shape, dtype=F32, device="meta")
    tfab.fused_ln_qkv(*kernel_args("fused_ln_qkv", inp))
    assert recorded[-1][1][2:] == (1, 1)


@pytest.mark.parametrize("name", KERNELS)
def test_wrapper_refuses_other_dtypes(recorded, name):
    """float16 activations, a float16 weight or vector, and activations of
    two dtypes raise ValueError before any launch."""
    fn = getattr(tfab, name)
    before = fn.launches
    half = meta_inputs(torch.float16, F32, F32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fn(*kernel_args(name, half))
    if name in ("attention_core", "attention_core_oproj"):
        mixed = meta_inputs(F32, F32, F32)
        mixed["qkv"][1] = mixed["qkv"][1].to(BF16)
        with pytest.raises(ValueError, match="one dtype"):
            fn(*kernel_args(name, mixed))
    if name != "attention_core":
        odd = meta_inputs(F32, F32, F32)
        odd["w"] = [w.to(torch.float16) for w in odd["w"]]
        odd["w_fc"] = odd["w_fc"].to(torch.float16)
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            fn(*kernel_args(name, odd))
    assert fn.launches == before and not recorded


@pytest.mark.parametrize("name", ["attention_core", "attention_core_oproj"])
def test_f32_attention_refuses_head_sizes_it_has_no_kernel_for(recorded,
                                                               name):
    inp = meta_inputs(F32, F32, F32, width=256, heads=8)  # head size 32
    with pytest.raises(ValueError, match="head size 32"):
        getattr(tfab, name)(*kernel_args(name, inp))
    bf = meta_inputs(BF16, BF16, BF16, width=256, heads=8)  # the bf16 form
    getattr(tfab, name)(*kernel_args(name, bf))
    assert len(recorded) == 1


# --- on the card: each form against its plain version -----------------------

# (images, tokens) at ViT-L widths (D 1024, 16 heads of 64, F 4096): the
# fp32 attention's held route with K in the score rows at ViT-L/14@336's 577
# tokens, its held route at an odd 197, its two-pass route at 650
CUDA_SHAPES = [(2, 577), (3, 197), (1, 650)]
# name -> (activations, vectors, weights)
CUDA_FORMS = {"f32": (F32, F32, F32), "f32_x_bf16_params": (F32, BF16, BF16),
              "bf16_x_f32_params": (BF16, F32, F32)}


def cuda_form_cases():
    for batch, seq in CUDA_SHAPES:
        for form in CUDA_FORMS:
            for name in KERNELS:
                if name == "attention_core" and form != "f32":
                    continue        # no parameters: its forms are q's dtype
                yield pytest.param(name, form, batch, seq, False,
                                   id=f"{name}-{form}-L{seq}")
        yield pytest.param("attention_core", "f32", batch, seq, True,
                           id=f"attention_core-f32-fast_exp-L{seq}")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # exact plain versions
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
@pytest.mark.parametrize("name,form,batch,seq,fast_exp", cuda_form_cases())
def test_cuda_form_matches_plain_version(card, name, form, batch, seq,
                                         fast_exp):
    """Each fp32 form by the fp32 rule (F32_TOL; with fast_exp
    fast_exp_flip_bound), the bf16-activation form with fp32 parameters by
    the bf16 forms' rule; one launch counted, outputs in x's dtype."""
    inp = vit_inputs(batch, seq, 1024, 16, *CUDA_FORMS[form], card)
    args = kernel_args(name, inp)
    kw = {"fast_exp": True} if fast_exp else {}
    fn, plain = getattr(tfab, name), getattr(tfab, name + "_plain")
    before = fn.launches
    got = as_tuple(fn(*args, **kw))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = as_tuple(plain(*args, **kw))
    act = CUDA_FORMS[form][0]
    bound = fast_exp_flip_bound(*inp["qkv"], 16) if fast_exp else None
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == act and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        if act == BF16:
            g, w = g.float(), w.float()
            assert bool(((g - w).abs() <= BF16_TOL * (1 + w.abs())).all()), \
                (g - w).abs().max().item()
            continue
        held, figures = f32_rule(name, g, w, bound)
        assert held, figures


@pytest.mark.gpu
@pytest.mark.parametrize("name", KERNELS[:3])
def test_cuda_mixed_form_rounds_to_the_bf16_form(card, name):
    """bf16 x with fp32 parameters that are bf16-valued: the mixed form's
    output bit-equal to the bf16 form's on the same values."""
    inp = vit_inputs(2, 577, 1024, 16, BF16, BF16, BF16, card, seed=1)
    widened = dict(inp, ln_s=inp["ln_s"].float(), ln_b=inp["ln_b"].float(),
                   w=[w.float() for w in inp["w"]],
                   b=[b.float() for b in inp["b"]],
                   w_fc=inp["w_fc"].float(), b_fc=inp["b_fc"].float(),
                   w_proj=inp["w_proj"].float(),
                   b_proj=inp["b_proj"].float())
    fn = getattr(tfab, name)
    want = as_tuple(fn(*kernel_args(name, inp)))
    got = as_tuple(fn(*kernel_args(name, widened)))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def launch_f32_attention(q, k, v, heads, route, fast_exp=False):
    """attention_core's fp32 kernel by ``route``: (the launcher's return
    code, the output)."""
    out = torch.full_like(q, 7.0)
    rc = tfab._launcher_of("vit_block", "attention_core", 4, 7, 0)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.shape[0], q.shape[1], heads, q.shape[2] // heads, int(fast_exp), 1,
        route, torch.cuda.current_stream(q.device).cuda_stream)
    torch.cuda.synchronize()
    return rc, out


@pytest.mark.gpu
@pytest.mark.parametrize("seq,route", [
    (seq, route) for seq in (130, 577) for route in (
        tfab.F32_TWO_PASS, tfab.F32_HELD, tfab.F32_HELD_KS)
    if not (seq == 577 and route == tfab.F32_HELD)]
    + [(640, tfab.F32_HELD_KS)])
@pytest.mark.parametrize("fast_exp", [False, True])
def test_cuda_f32_attention_routes_match_plain(card, seq, route, fast_exp):
    """Each route of the fp32 attention where it fits, whatever the wrapper
    would pick (an odd number of key tiles at 130 tokens; the held route
    with K in the score rows, E·V on the tensor cores, also at its longest,
    640 keys), by the fp32 rule against the plain version."""
    inp = vit_inputs(2, seq, 1024, 16, F32, F32, F32, card, seed=2)
    rc, got = launch_f32_attention(*inp["qkv"], 16, route, fast_exp)
    assert rc == 0
    want = tfab.attention_core_plain(*inp["qkv"], 16, fast_exp=fast_exp)
    bound = fast_exp_flip_bound(*inp["qkv"], 16) if fast_exp else None
    held, figures = f32_rule("attention_core", got, want, bound)
    assert held, figures


@pytest.mark.gpu
@pytest.mark.parametrize("seq,route", [(577, tfab.F32_HELD),
                                       (641, tfab.F32_HELD_KS)])
def test_cuda_f32_held_launchers_refuse_past_their_limits(card, seq, route):
    """Each held route returns an error, and launches nothing, one key past
    what its score rows hold at head size 64, and runs at that limit: the
    wrapper's route and the header's limits cannot part."""
    q, k, v = (torch.zeros(1, seq, 128, device=card) for _ in range(3))
    rc, out = launch_f32_attention(q, k, v, 2, route)
    assert rc != 0 and bool((out == 7.0).all())
    rc, out = launch_f32_attention(q[:, 1:], k[:, 1:], v[:, 1:], 2, route)
    assert rc == 0 and bool((out == 0).all())
    rc, out = launch_f32_attention(q, k, v, 2, tfab.F32_TWO_PASS)
    assert rc == 0 and bool((out == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("route", [tfab.F32_HELD, tfab.F32_HELD_KS])
def test_cuda_f32_held_launchers_batch_limits(card, route):
    """65,536 images of one token: the held route (the batch on the grid's
    x) runs them; the held route with K in the score rows (the batch on
    the grid's z) returns an error and launches nothing, and runs 65,535.
    One key gives each output its v, 1."""
    q, k, v = (torch.ones(65536, 1, 128, device=card) for _ in range(3))
    rc, out = launch_f32_attention(q, k, v, 2, route)
    if route == tfab.F32_HELD:
        assert rc == 0 and bool((out == 1).all())
        return
    assert rc != 0 and bool((out == 7.0).all())
    rc, out = launch_f32_attention(q[1:], k[1:], v[1:], 2, route)
    assert rc == 0 and bool((out == 1).all())


@pytest.mark.parametrize("table,name", [
    (table, name) for table in ("F32_CUTS", "VIT_F32_CUTS")
    for name in getattr(kernel_probe, table)])
def test_probe_cuts_find_their_text(table, name):
    """Each part that kernel_probe's --f32-split and --vit-f32-split cut
    names text that this tree's sources hold, and the cut changes it."""
    file, old, new = getattr(kernel_probe, table)[name]
    text = (kernels.CSRC_DIR / file).read_text()
    assert old in text and old != new
