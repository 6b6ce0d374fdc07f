"""The port's (data, model) mesh over processes (parallel/mesh.py) against
the JAX package's mesh rules, and the backend rule (parallel/multihost.py).

  * ``make_mesh``'s sizes and errors equal JAX ``make_mesh``'s (its
    shape, its messages) for data -1, model 2, the hybrid dcn_data axis,
    the pipe fold, mismatches and dcn_data with pipe (JAX's hybrid mesh
    asks for TPU slices on the CPU: its sizes are held to JAX's rule);
  * ``make_data_mesh``: 0 or 1 no mesh, -1 every rank, wider raises;
  * the backend: NCCL where every rank of a node has a card of its own,
    gloo where ranks share one or there is none;
  * over four gloo ranks (spawned once, tests/torch_mesh_ranks.py): the
    coordinates in JAX's order (data outer, model inner), the axis groups,
    the batch rows of each data coordinate, the mapper broadcast from rank
    0, the predictions gathered from each model group's first rank, the
    metric and the gradients summed over the data axes only, and the
    conjugate pair (all-reduce forward, identity backward; identity
    forward, all-reduce backward).

The ``gpu`` cases hold rows 1 and 5 at a model rank's 16 heads of T0-3B
and row 6's residual-free form at its FFN shard (wi 2048 x 2560, wo 2560 x
2048) against their plain versions on the card; this file imports JAX only
in its fixtures, so that the card's machine collects them.
"""

import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
    fused_attention_block as tfab,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.parallel import mesh as pm
from explicit_alignment_for_vqa_tasks_tpu_torch.parallel import (
    multihost as tmh,
)

import torch_mesh_ranks as ranks

SIZES = [
    ({"data": -1, "model": 1}, 8),
    ({"data": -1, "model": 2}, 8),
    ({"data": 4, "model": 2}, 8),
    ({"data": 0, "model": -1}, 4),
    ({"data": 2, "model": 2, "pipe": 2}, 8),     # pipe folds into data
    ({"data": -1, "model": 2, "pipe": 2}, 8),    # no fold: data the rest
    ({"data": 3, "model": 2}, 8),                # mismatch
    ({"data": 2, "model": 2, "pipe": 3}, 8),     # no fold, mismatch
]
DCN = [
    ({"dcn_data": 2, "data": -1, "model": 2}, 8,
     {"dcn_data": 2, "data": 2, "model": 2}),
    ({"dcn_data": 2, "data": 1, "model": 2}, 4,
     {"dcn_data": 2, "data": 1, "model": 2}),
    ({"dcn_data": 2, "data": 3, "model": 2}, 8, "dcn_data=2 x data=3"),
    ({"dcn_data": 2, "data": -1, "model": 2, "pipe": 2}, 8, "pipe > 1"),
]


@pytest.fixture(scope="module")
def jax_mesh():
    jax = pytest.importorskip("jax")
    from explicit_alignment_for_vqa_tasks_tpu.parallel import mesh as jmesh
    from explicit_alignment_for_vqa_tasks_tpu.utils.attr_dict import AttrDict

    def make(sizes, n):
        return jmesh.make_mesh(AttrDict(tpu={"mesh": sizes}),
                               devices=jax.devices()[:n])
    return make


@pytest.mark.parametrize("sizes,n", SIZES)
def test_mesh_sizes_equal_jax(jax_mesh, sizes, n):
    config = {"tpu": {"mesh": sizes}}
    try:
        want = dict(jax_mesh(sizes, n).shape)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            pm.make_mesh(config, n)
        assert str(got.value) == str(exc)
        return
    mesh = pm.make_mesh(config, n)
    assert mesh.shape == want and mesh.axis_names == tuple(want)
    assert mesh.coords == {ax: 0 for ax in want} and mesh.member
    assert mesh.data_size == want["data"]


@pytest.mark.parametrize("sizes,n,want", DCN)
def test_hybrid_dcn_sizes_follow_jax(jax_mesh, sizes, n, want):
    config = {"tpu": {"mesh": sizes}}
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want.replace("(", r"\(")) as got:
            pm.make_mesh(config, n)
        if "pipe" in sizes:   # raised before JAX builds its hybrid mesh
            with pytest.raises(ValueError) as jgot:
                jax_mesh(sizes, n)
            assert str(jgot.value) == str(got.value)
        return
    mesh = pm.make_mesh(config, n)
    assert mesh.shape == want
    assert pm.data_axes(mesh) == ("dcn_data", "data")
    assert mesh.data_size == want["dcn_data"] * want["data"]


def test_data_mesh_rules():
    assert pm.make_data_mesh(0) is None and pm.make_data_mesh(1) is None
    assert pm.make_data_mesh(-1) is None      # one process: one card
    assert pm.make_data_mesh(-1, world=4).shape == {"data": 4, "model": 1}
    with pytest.raises(ValueError, match="--mesh_data 5 > 4"):
        pm.make_data_mesh(5, world=4)
    with pytest.raises(ValueError, match="--mesh_data 2 of 4 processes"):
        pm.make_data_mesh(2, world=4)


@pytest.mark.parametrize("cards,local,want", [
    (0, 1, "gloo"), (0, 2, "gloo"), (1, 1, "nccl"), (1, 2, "gloo"),
    (2, 2, "nccl"), (4, 2, "nccl"), (2, 4, "gloo")])
def test_backend_follows_the_topology(cards, local, want):
    assert tmh.choose_backend(cards, local) == want


def test_backend_reads_the_launcher(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert tmh.choose_backend() == "gloo"      # two ranks on one card
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert tmh.choose_backend() == "nccl"
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert tmh.choose_backend() == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tmh.choose_backend() == "gloo"


def test_param_specs_are_megatrons():
    tree = {"encoder": {"self_attn": {n: torch.zeros(2, 4, 4)
                                      for n in ("q", "k", "v", "o")},
                        "ffn_q8": {"wi_0": torch.zeros(2, 4, 4)},
                        "rel_bias": torch.zeros(8, 4)},
            "shared": torch.zeros(10, 4)}
    specs = pm.t5_param_specs(tree)
    assert specs["encoder"]["self_attn"]["q"] == (None, None, "model")
    assert specs["encoder"]["self_attn"]["o"] == (None, "model", None)
    assert specs["encoder"]["ffn_q8"]["wi_0"] == ()
    assert specs["encoder"]["rel_bias"] == () and specs["shared"] == ()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return ranks.run_ranks(ranks.mesh_worker, 4,
                           tmp_path_factory.mktemp("mesh_ranks"))


def test_coordinates_and_groups(run):
    for rank, rec in enumerate(run):
        two, dcn = rec["2d"], rec["dcn"]
        assert two["coords"] == {"data": rank // 2, "model": rank % 2}
        assert two["groups"] == {"data": [rank % 2, rank % 2 + 2],
                                 "model": [rank - rank % 2,
                                           rank - rank % 2 + 1]}
        assert two["data_group"] == two["groups"]["data"]
        assert dcn["coords"] == {"dcn_data": rank // 2, "data": 0,
                                 "model": rank % 2}
        assert dcn["groups"] == {"dcn_data": [rank % 2, rank % 2 + 2],
                                 "model": two["groups"]["model"]}
        assert dcn["data_group"] == two["data_group"]
        for rec_ in (two, dcn):
            assert rec_["shard"] == (rank // 2, 2) == (rec_["data"], 2)


def test_batch_rows_broadcast_and_gathers(run):
    for rank, rec in enumerate(run):
        for name in ("2d", "dcn"):
            got = rec[name]
            d = rank // 2
            assert got["rows"] == [4.0 * d + i for i in range(4)]
            assert got["mapper"] == [[0.0, 0.0], [0.0, 0.0]]
            assert got["predictions"] == ["d0m0", "d1m0"]
            # rank + 1 summed over the data axes at this model coordinate
            assert got["psum"] == (rank % 2 + 1) + (rank % 2 + 3)
            assert got["grad"] == [float(2 * (rank % 2) + 2)] * 3
            assert got["max"] == rank % 2 + 2
            # all-reduce of 2 x over the model group forward; the gradient
            # of the sum, 2 a rank, all-reduced backward
            group = [rank - rank % 2, rank - rank % 2 + 1]
            assert got["reduced"] == [2.0 * sum(r + 1 for r in group)] * 2
            assert got["x_grad"] == [4.0, 4.0]


# --- row 6's partial form: the limit that keeps its partial fp32 -----------

# The partial form's relative Frobenius error against plain. Its fp32
# partial differs from plain's by the kernel's sum order (1.59e-4 on an
# H100 at T0-3B's shard); a partial rounded to bf16 before it is stored
# reads about 1.5e-3 and must fail. chip_smoke.py holds the same limit.
PARTIAL_FFN_REL = 5e-4


def _t0_shard(gen, device, lead, gated=True):
    """(x, ln, wi_0, wi_1, wo) at T0-3B's model-2 FFN shard (wi 2048 x
    2560, wo 2560 x 2048), x of shape ``lead`` + (2048,), bf16."""
    d, f = 2048, 2560

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    x = randn(*lead, d, scale=2.0).bfloat16()
    ln = (1 + 0.1 * randn(d)).bfloat16()
    wi0 = randn(d, f, scale=d ** -0.5).bfloat16()
    wi1 = randn(d, f, scale=d ** -0.5).bfloat16() if gated else None
    wo = randn(f, d, scale=f ** -0.5).bfloat16()
    return x, ln, wi0, wi1, wo


def _rel(got, want):
    return float((got.float() - want).norm() / want.norm())


@pytest.mark.parametrize("gated", [True, False])
def test_partial_ffn_limit_rejects_a_bf16_partial(gated):
    """The plain partial rounded to bf16, the fault the fp32 partial
    exists to avoid, lies beyond PARTIAL_FFN_REL, and more than twice the
    H100's sound reading lies within it."""
    args = _t0_shard(torch.Generator().manual_seed(0), "cpu", (2, 32), gated)
    want = tfab.fused_t5_ffn_plain(*args, residual=False)
    assert want.dtype == torch.float32
    assert _rel(want.bfloat16(), want) > 2 * PARTIAL_FFN_REL
    assert 2 * 1.59e-4 < PARTIAL_FFN_REL


# --- on the card: the kernels at a model rank's widths ----------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
@pytest.mark.parametrize("gated", [True, False])
def test_cuda_partial_ffn_at_the_t0_shard_matches_plain(gated):
    """Row 6's residual-free form at T0-3B's model-2 shard, fp32 partials:
    relative Frobenius error within PARTIAL_FFN_REL, which a partial
    rounded to bf16 exceeds, and every element within 1.6e-2 of (|want| +
    rms(want)), the rule of tests/test_torch_fused_t5_ffn.py's bf16 kernel
    test (an fp32 sum in another order can move a bf16 rounding of h or
    hid)."""
    x, ln, wi0, wi1, wo = _t0_shard(_cuda(), "cuda", (2, 300), gated)
    before = tfab.fused_t5_ffn.launches
    got = tfab.fused_t5_ffn(x, ln, wi0, wi1, wo, residual=False)
    assert tfab.fused_t5_ffn.launches == before + 1
    want = tfab.fused_t5_ffn_plain(x, ln, wi0, wi1, wo, residual=False)
    assert got.dtype == want.dtype == torch.float32
    assert _rel(got, want) <= PARTIAL_FFN_REL
    rms = want.square().mean().sqrt()
    assert bool(((got - want).abs() <= 1.6e-2 * (want.abs() + rms)).all())


@pytest.mark.gpu
def test_cuda_partial_ffn_limit_rejects_the_planted_bf16_partial():
    """The fault planted: the kernel's partial and plain's, each rounded to
    bf16 as a partial stored in bf16 would be, fail PARTIAL_FFN_REL, where
    the kernel's fp32 partial passes it."""
    args = _t0_shard(_cuda(), "cuda", (2, 300))
    got = tfab.fused_t5_ffn(*args, residual=False)
    want = tfab.fused_t5_ffn_plain(*args, residual=False)
    assert _rel(got, want) <= PARTIAL_FFN_REL
    assert _rel(got.bfloat16(), want) > PARTIAL_FFN_REL
    assert _rel(want.bfloat16(), want) > PARTIAL_FFN_REL


@pytest.mark.gpu
def test_cuda_t5_attention_core_at_16_heads_matches_plain():
    """Row 1 at a model rank's 16 of T0-3B's 32 heads (557 keys, a padded
    row), with its heads' slice of the bias: within 8e-3 of plain
    (tests/test_torch_attention_core.py's rule), the bias tiles the same
    bits as the bias."""
    gen = _cuda()
    heads, dh, length, batch = 16, 64, 557, 4
    q, k, v = (torch.randn(batch, length, heads * dh, generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    whole = torch.randn(32, length, length, generator=gen, device="cuda")
    bias = whole[16:].contiguous()
    mask = torch.ones(batch, length, dtype=torch.int32, device="cuda")
    mask[1, 500:] = 0
    before = tfab.t5_attention_core.launches
    got = tfab.t5_attention_core(q, k, v, bias, mask, heads,
                                 tfab.t5_bias_tiles(bias))
    assert tfab.t5_attention_core.launches == before + 1
    want = tfab.t5_attention_core_plain(q, k, v, bias, mask, heads)
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=8e-3)
    assert torch.equal(tfab.t5_attention_core(q, k, v, bias, mask, heads),
                       got)


@pytest.mark.gpu
def test_cuda_cross_attention_decode_at_16_heads_matches_plain():
    """Row 5 at 16 heads over a local-head cross cache (layer 1 of 2),
    within 8e-3 of plain (tests/test_torch_decode_attention.py's rule)."""
    from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (
        decode_attention as tdec,
    )

    gen = _cuda()
    heads, dh, length, batch, layers = 16, 64, 557, 4, 2

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q = rand(batch, heads * dh)
    ck, cv = (rand(layers, batch, length, heads * dh) for _ in range(2))
    mask = torch.ones(batch, length, dtype=torch.int32, device="cuda")
    mask[2, 400:] = 0
    before = tdec.cross_attention_decode.launches
    got = tdec.cross_attention_decode(q, ck, cv, mask, 1, heads)
    assert tdec.cross_attention_decode.launches == before + 1
    want = tdec.cross_attention_decode_plain(q, ck, cv, mask, 1, heads)
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=8e-3)
