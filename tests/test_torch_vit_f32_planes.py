"""A CPU model of E·V in the fp32 ViT attention's held route with K in the
score rows (csrc/attention_f32.cuh, `vit_f32_route`'s F32_HELD_KS: rows 9,
11, 16 and 17 fp32 at ViT-L/14@336's 577 keys). There the scores, the
row's max, every p = exp(s - max) and the row sums are the CUDA-core fp32
route's; only e·v runs on the tensor cores: p and v each split into three
bf16 planes (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)),
six plane products smallest first, each 16-key step of `wgmma` summed into
an fp32 accumulator that truncates, each 64-key tile into a fresh
accumulator set that is added in fp32 into the o of the warpgroup that
takes it (the two take alternate tiles), the two warpgroups' o added, then
divided by the row sum. The model holds that
order to the plain version and to the JAX package's Pallas kernel by the
fp32 rule, on scores up to about 35; the kernel itself is held to the plain
version on the card (tests/test_torch_vit_f32_kernels.py)."""

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
    fused_attention_block as tfab,
)
from test_torch_vit_q8_kernels import jax_attention_core, normal  # noqa: E402

# the fp32 rule: every output within F32_TOL (1 + |want|)
F32_TOL = 1e-5
SEQ, HEADS, DH = 577, 4, 64
TILE, STEP = 64, 16  # keys a tile; keys a wgmma k step
# (p plane, v plane) of each product, smallest first: lo.hi, mid.mid,
# hi.lo, mid.hi, hi.mid, hi.hi (csrc/attention_f32.cuh's ev_e_plane and
# ev_v_plane; planes 0 hi, 1 mid, 2 lo)
PRODUCTS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
# below this magnitude the lo plane is a bf16 subnormal and may drop bits
LO_EXACT_FROM = 2.0 ** -110


def planes(x):
    """x's three bf16 planes (as fp32 tensors): hi, mid, lo."""
    hi = x.bfloat16().float()
    rest = x - hi
    mid = rest.bfloat16().float()
    return hi, mid, (rest - mid).bfloat16().float()


def toward_zero(y):
    """fp64 y rounded to fp32 toward zero, as the tensor cores' fp32
    accumulator keeps a sum."""
    f = y.float()
    over = f.double().abs() > y.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def ev_on_planes(p, v):
    """sum_j p_j v_j in the kernel's order: p (H, L, Lk), v (H, Lk, dh),
    fp32; keys past Lk padded with zeros to whole tiles. Each 16-key step
    of a product is summed exactly (fp64, whose rounding lies far below
    fp32's) and added into the accumulator toward zero."""
    pad = -p.shape[-1] % TILE
    p = torch.nn.functional.pad(p, (0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    pp, vp = planes(p), planes(v)
    halves = []
    for g in range(2):  # the warpgroups: tiles g, g + 2, ...
        o = torch.zeros(p.shape[:-1] + v.shape[-1:])
        for t in range(g, p.shape[-1] // TILE, 2):
            acc = None
            for e, f in PRODUCTS:
                for kk in range(TILE // STEP):
                    k0 = TILE * t + STEP * kk
                    keys = slice(k0, k0 + STEP)
                    step = pp[e][..., keys].double() @ vp[f][..., keys, :] \
                        .double()
                    acc = toward_zero(step if acc is None
                                      else acc.double() + step)
            o = o + acc
        halves.append(o)
    return halves[0] + halves[1]


def model_attention(q, k, v):
    """attention_core's fp32 form with E·V as ev_on_planes, the rest as the
    plain version computes it: (B, L, H dh) pre-scaled q."""
    batch, seq, width = q.shape

    def heads(t):
        return t.reshape(batch, seq, HEADS, DH).transpose(1, 2)

    s = heads(q) @ heads(k).transpose(-1, -2)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = ev_on_planes(p, heads(v)) / p.sum(dim=-1, keepdim=True)
    return o.transpose(1, 2).reshape(batch, seq, width)


@pytest.fixture(scope="module")
def case():
    """ViT-L/14@336's 577 keys on 4 heads of 64, pre-scaled q, k and v at
    0.5, 2 and 1 N(0, 1) (the card tests' scales): the model's output, the
    plain version's and the scores' largest magnitude."""
    rng = np.random.default_rng(26)
    qkv = [normal(rng, 1, SEQ, HEADS * DH, scale=s) for s in (0.5, 2.0, 1.0)]
    q, k, v = (torch.from_numpy(a) for a in qkv)
    s = (q.reshape(SEQ, HEADS, DH).transpose(0, 1)
         @ k.reshape(SEQ, HEADS, DH).permute(1, 2, 0))
    return dict(qkv=qkv, model=model_attention(q, k, v),
                plain=tfab.attention_core_plain(q, k, v, HEADS),
                top=s.abs().max().item())


def rule(got, want):
    """(every output within F32_TOL (1 + |want|), the largest error)."""
    err = (got.double() - want.double()).abs()
    return bool((err <= F32_TOL * (1 + want.double().abs())).all()), \
        err.max().item()


def test_plane_order_meets_the_fp32_rule_against_plain(case):
    """Scores up to about 35 (where q·kᵀ as bf16-plane products on the
    tensor cores misses the rule): the plane order of E·V alone stays
    within the rule of the plain version, with room (under a third of
    it)."""
    assert 30 < case["top"] < 45
    held, err = rule(case["model"], case["plain"])
    assert held and err < F32_TOL / 3, err


def test_plane_order_meets_the_fp32_rule_against_pallas(case):
    """The same model against the JAX package's attention_core, in
    interpret mode on the same fp32 inputs."""
    import jax.numpy as jnp

    want = np.asarray(jax_attention_core(
        [jnp.asarray(a) for a in case["qkv"]], HEADS))
    held, err = rule(case["model"], torch.from_numpy(want))
    assert held, err


def test_planes_sum_to_their_value():
    """hi + mid + lo == x exactly for every p = exp(s - max) down to
    LO_EXACT_FROM (2^-110) and for v of either sign across fp32's normal
    range above it; below, lo is a bf16 subnormal (its last bit 2^-133)
    and the sum is off by at most 2^-134. A p that small weighs at most
    2^-110 of the row's largest p (which is 1), so the sum's error, and
    the tensor cores' flushing such a plane to zero if they do, moves an
    output by at most about 2^-110 |v|: nowhere near 1e-5 (1 + |want|)."""
    d = torch.linspace(-104.0, 0.0, 200001)
    p = torch.exp(d)
    rng = np.random.default_rng(0)
    v = torch.from_numpy(
        (rng.standard_normal(200001) * np.exp2(rng.uniform(-100, 100, 200001)))
        .astype(np.float32))
    for x in (p, v, -v):
        total = sum(t.double() for t in planes(x))
        err = (total - x.double()).abs()
        big = x.abs() >= LO_EXACT_FROM
        assert big.any() and bool((err[big] == 0).all())
        assert bool((err[~big] <= 2.0 ** -134).all())
    # below it, lo does lose bits somewhere
    tiny = p[(p > 0) & (p < LO_EXACT_FROM)]
    assert bool((sum(t.double() for t in planes(tiny)) != tiny.double()).any())


def test_fresh_sets_a_tile_keep_the_truncation_small(case):
    """Why each tile starts a fresh accumulator set: one set over all 577
    keys, every product's steps truncated at the full sum's magnitude, lies
    more than twice as far from plain on the same inputs."""
    q, k, v = (torch.from_numpy(a) for a in case["qkv"])

    def heads(t):
        return t.reshape(1, SEQ, HEADS, DH).transpose(1, 2)

    s = heads(q) @ heads(k).transpose(-1, -2)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    pp, vp = planes(p), planes(heads(v))
    # one accumulator over every key and product, truncating each step
    acc = None
    for e, f in PRODUCTS:
        for k0 in range(0, SEQ, STEP):
            step = pp[e][..., k0:k0 + STEP].double() \
                @ vp[f][..., k0:k0 + STEP, :].double()
            acc = toward_zero(step if acc is None else acc.double() + step)
    one_set = (acc / denom).transpose(1, 2).reshape(1, SEQ, HEADS * DH)
    _, tiled_err = rule(case["model"], case["plain"])
    _, one_set_err = rule(one_set, case["plain"])
    assert one_set_err > 2 * tiled_err, (one_set_err, tiled_err)
