"""The port's tensor-parallel T5 against the JAX package's, on the CPU.

Four gloo ranks (spawned once, tests/torch_mesh_ranks.py) run the small
VC-T0 on (data 1, model 2) (ranks 0 and 1), (data 2, model 2) and
(dcn_data 2, data 1, model 2): the whole tree quantized where the case
asks, split by ``shard_lm_params``, the batch split by the data
coordinate. Against JAX's single-device run and its mesh run (the 8
virtual CPU devices; JAX's hybrid ``dcn_data`` mesh is built by hand, since
``make_mesh`` asks for TPU slices there), at JAX's tolerances
(tests/test_sharding.py:64, tests/test_generate_mesh.py:63-182):

  * greedy and beam tokens equal;
  * fp32 encoder states within 1e-5 (1 + |want|), bf16 ones within a
    relative Frobenius error of 5e-3;
  * the int8 encoder FFN and the int8 decoder step (bf16 decoder weights
    dropped: the replicated ``step_q8``, the cross cache gathered to every
    head) give equal tokens;
  * each rank's leaves of ``shard_lm_params`` equal its addressable shard
    of JAX's ``t5_param_specs`` placement.

The kernels of the path (rows 1, 5 and 6) run their plain versions here;
their ``gpu`` cases at 16 heads and at T0-3B's FFN shard are in
tests/test_torch_mesh.py, which the card's machine (no JAX) can collect.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.models import mappers as jmap  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import t5 as jt5  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.models import vct0 as jvct0  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.parallel import mesh as jmesh  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu.utils.attr_dict import AttrDict  # noqa: E402
from explicit_alignment_for_vqa_tasks_tpu_torch.ops import (  # noqa: E402
    fused_attention_block as tfab,
)

import torch_mesh_ranks as ranks  # noqa: E402

S = 32099            # <extra_id_0>
BATCH, LENGTH, PREFIX = 8, 6, 16
STEPS = 4
MAPPER = dict(mapping_type="mlp", prefix_size=PREFIX, d_model=32,
              prefix_length=3, clip_length=3)
FUSED = dict(fused_encoder_attention=True, fused_decode_attention=True)
CASES = {
    "fp32_fused": dict(lm=FUSED, beams=0),
    "fp32": dict(lm={}, beams=3),
    # the fused FFN rounds h and its hidden to bf16 whatever x's dtype: a
    # sum in another order flips roundings (tests/test_torch_fused_t5_ffn.py
    # ::test_encode_with_fused_ffn_matches_jax), so its fp32 form is held
    # by the bf16 rule
    "fp32_ffn": dict(lm=dict(FUSED, fused_encoder_ffn=True), beams=0),
    "bf16_fused": dict(lm=dict(FUSED, fused_encoder_ffn=True, bf16=True),
                       beams=0),
    "int8_ffn": dict(lm=dict(int8_encoder_ffn=True), beams=0),
    "int8_step": dict(lm=dict(int8_decoder_step=True), beams=0),
}
for _case in CASES.values():
    _case.update(mapper=MAPPER, steps=STEPS)


def jax_config(case):
    lm = dict(case["lm"])
    if lm.pop("bf16", False):
        lm["dtype"] = jnp.bfloat16
    return jvct0.VCT0Config(lm=jt5.T5Config.small_test(**lm),
                            mapper=jmap.MapperConfig(**case["mapper"]))


def jax_params(params, case):
    cfg = jax_config(case)
    lm = params["lm"]
    if cfg.lm.dtype == jnp.bfloat16:
        lm = jax.tree.map(lambda a: a.astype(jnp.bfloat16), lm)
    if cfg.lm.int8_encoder_ffn:
        lm = jt5.quantize_encoder_ffn(lm)
    if cfg.lm.int8_decoder_step:
        lm = jt5.quantize_decoder_step(lm, drop_bf16=True)
    return cfg, {"lm": lm, "mapper": params["mapper"]}


def jax_mesh(sizes):
    devices = np.asarray(jax.devices())
    if "dcn_data" in sizes:
        return Mesh(devices[:4].reshape(2, 1, 2),
                    ("dcn_data", "data", "model"))
    return jmesh.make_mesh(AttrDict(tpu={"mesh": sizes}),
                           devices=list(devices[:sizes["data"]
                                                * sizes["model"]]))


def jax_run(cfg, params, inputs, mesh=None, beams=0):
    """(encoder states, greedy tokens, beam tokens or None) of JAX's
    VCT0Model, on one device or on ``mesh``."""
    prefix, ids, mask = (jnp.asarray(inputs[k])
                         for k in ("prefix", "ids", "mask"))
    if mesh is not None:
        params = {"lm": jmesh.shard_lm_params(mesh, params["lm"]),
                  "mapper": jmesh.replicate_params(mesh, params["mapper"])}
        sh = NamedSharding(mesh, P(jmesh.data_axes(mesh)))
        prefix, ids, mask = (jax.device_put(x, sh) for x in (prefix, ids,
                                                             mask))
    model = jvct0.VCT0Model(cfg, params)
    embeds, emask = model.encoder_calibration_batch(prefix, ids, mask)
    hidden = jt5.t5_encode(params["lm"], cfg.lm, inputs_embeds=embeds,
                           attention_mask=emask)
    tokens, _ = model.generate(prefix, ids, mask, max_new_tokens=STEPS)
    beam = None
    if beams:
        beam = np.asarray(model.generate(prefix, ids, mask,
                                         max_new_tokens=STEPS,
                                         num_beams=beams)[0])
    return (np.asarray(hidden.astype(jnp.float32)), np.asarray(tokens),
            beam)


def make_inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1000, size=(BATCH, LENGTH)).astype(np.int32)
    ids[:, 0] = S
    mask = np.ones((BATCH, LENGTH), np.int32)
    mask[1, 4:] = 0
    ids[1, 4:] = 0
    prefix = rng.standard_normal((BATCH, 1, PREFIX)).astype(np.float32)
    return {"prefix": prefix, "ids": ids, "mask": mask}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = jax_config(CASES["fp32"])
    params = jvct0.init_vct0_params(jax.random.PRNGKey(0), jcfg,
                                    param_dtype=jnp.float32)
    params_np = jax.tree.map(np.asarray, params)
    inputs = make_inputs()
    got = ranks.run_ranks(ranks.tp_worker, 4,
                          tmp_path_factory.mktemp("tp_ranks"), params_np,
                          CASES, inputs)
    single = {}
    for name, case in CASES.items():
        cfg, p = jax_params(params, case)
        single[name] = jax_run(cfg, p, inputs, beams=case["beams"])
    on_mesh = {}
    cfg, p = jax_params(params, CASES["fp32_fused"])
    for mesh_name, sizes, _ in ranks.TP_MESHES:
        with jax_mesh(sizes) as mesh:
            on_mesh[mesh_name] = jax_run(cfg, p, inputs, mesh=mesh)
    return dict(params=params, got=got, single=single, on_mesh=on_mesh)


def joined(runs, mesh_name, case, key):
    """A case's output over the batch: each data shard's model-rank-0
    rows in data order, after checking that the model ranks agree."""
    recs = [r[(mesh_name, case)] for r in runs["got"]
            if (mesh_name, case) in r]
    shards = {}
    for rec in recs:
        if rec["data"] in shards:
            np.testing.assert_array_equal(rec[key], shards[rec["data"]])
        shards[rec["data"]] = rec[key]
    assert sorted(shards) == list(range(len(shards)))
    return np.concatenate([shards[d] for d in sorted(shards)])


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * (1 + np.abs(want).max()))
    assert np.all(np.abs(got - want) <= tol * (1 + np.abs(want)))


MESHES = [m for m, _, _ in ranks.TP_MESHES]


@pytest.mark.parametrize("mesh_name", MESHES)
def test_fp32_encode_and_greedy_match_jax(runs, mesh_name):
    hidden, tokens, _ = runs["single"]["fp32_fused"]
    m_hidden, m_tokens, _ = runs["on_mesh"][mesh_name]
    np.testing.assert_array_equal(m_tokens, tokens)
    for case in ("fp32_fused", "fp32"):
        got = joined(runs, mesh_name, case, "hidden")
        close(got, runs["single"][case][0])
        close(got, m_hidden)
        np.testing.assert_array_equal(
            joined(runs, mesh_name, case, "tokens"), runs["single"][case][1])
    np.testing.assert_array_equal(
        joined(runs, mesh_name, "fp32_fused", "tokens"), m_tokens)


@pytest.mark.parametrize("mesh_name", MESHES)
def test_beam_tokens_match_jax(runs, mesh_name):
    np.testing.assert_array_equal(joined(runs, mesh_name, "fp32", "beam"),
                                  runs["single"]["fp32"][2])


@pytest.mark.parametrize("case", ["bf16_fused", "fp32_ffn"])
@pytest.mark.parametrize("mesh_name", MESHES)
def test_bf16_encode_within_frobenius(runs, mesh_name, case):
    """The bf16 encoder, and the fused FFN's partial form (bf16 products)
    on fp32 activations: a relative Frobenius error within 5e-3."""
    want = runs["single"][case][0]
    got = joined(runs, mesh_name, case, "hidden")
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= 5e-3, err


@pytest.mark.parametrize("case", ["int8_ffn", "int8_step"])
@pytest.mark.parametrize("mesh_name", MESHES)
def test_int8_generate_tokens_equal(runs, mesh_name, case):
    np.testing.assert_array_equal(joined(runs, mesh_name, case, "tokens"),
                                  runs["single"][case][1])


def test_shards_are_jax_addressable_shards(runs):
    """Every leaf of each rank's shard_lm_params (int8 subtrees included)
    equals the addressable shard of JAX's placement at its model
    coordinate; whole leaves are whole."""
    params = runs["params"]
    lm = jt5.quantize_decoder_step(jt5.quantize_encoder_ffn(params["lm"]))
    with jax_mesh({"data": 2, "model": 2}) as mesh:
        placed = jmesh.shard_lm_params(mesh, lm)
    devices = np.asarray(mesh.devices)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(placed))
    for rec in runs["got"]:
        shard = rec["shards"]
        device = devices[rec["shards_data"], rec["shards_model"]]
        for path, leaf in flat_want.items():
            node = shard
            for key in path:
                node = node[key.key]
            want = [s.data for s in leaf.addressable_shards
                    if s.device == device][0]
            np.testing.assert_array_equal(node, np.asarray(want))


def test_partial_ffn_sums_to_the_whole_form():
    """Row 6's form without the residual: the fp32 partials of a column /
    row split of the weights, summed, plus x once, give the whole form
    (plain versions, fp32 x and bf16 x)."""
    gen = torch.Generator().manual_seed(3)
    d, f = 32, 64
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(2, 5, d, generator=gen).to(dtype)
        ln = (1 + 0.1 * torch.randn(d, generator=gen)).to(dtype)
        wi0, wi1 = (torch.randn(d, f, generator=gen) * d ** -0.5
                    for _ in range(2))
        wo = torch.randn(f, d, generator=gen) * f ** -0.5
        whole = tfab.fused_t5_ffn(x, ln, wi0, wi1, wo)
        parts = [tfab.fused_t5_ffn(x, ln, wi0[:, c], wi1[:, c], wo[c],
                                   residual=False)
                 for c in (slice(0, f // 2), slice(f // 2, f))]
        assert all(p.dtype == torch.float32 for p in parts)
        summed = (x.float() + parts[0] + parts[1]).to(dtype)
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(summed.float(), whole.float(), rtol=tol,
                                   atol=tol)


def test_unsplit_params_take_no_collective():
    """With whole weights the T5 runs as before: no active mesh is asked;
    split weights with no mesh to sum over raise."""
    from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5
    from explicit_alignment_for_vqa_tasks_tpu_torch.parallel import mesh as pm

    assert pm.active_mesh() is None
    cfg = tt5.T5Config.small_test()
    params = tt5.init_t5_params(torch.Generator().manual_seed(0), cfg,
                                torch.float32)
    tt5.t5_encode(params, cfg, input_ids=torch.ones(1, 3, dtype=torch.int32))
    half = dataclasses.replace(cfg, num_heads=cfg.num_heads * 2)
    with pytest.raises(ValueError, match="shard_lm_params"):
        tt5.t5_encode(params, half,
                      input_ids=torch.ones(1, 3, dtype=torch.int32))
