"""The port's model factory and bench against the JAX package's, in one
process on the CPU: the shipped VQA2 config built at ``T5_test`` size over
the compute dtype and fused-kernel grid (every ``T5Config`` field, and
JAX's greedy tokens on JAX's params carried across by ``convert.py``), the
ClipCap config, ``t5_params_from_hf`` on a local HF witness, the bench's
body and each of its flags; on the card (``gpu``, skipped here), the fp32
forms of ``t5_attention_core``, ``cross_attention_decode`` and
``fused_t5_ffn`` against their plain versions."""

import ast
import dataclasses
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from explicit_alignment_for_vqa_tasks_tpu_torch import main as tmain
from explicit_alignment_for_vqa_tasks_tpu_torch.convert import (
    vct0_params_from_numpy,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.models import hf_convert as thf
from explicit_alignment_for_vqa_tasks_tpu_torch.models import t5 as tt5
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.decode_attention import (
    cross_attention_decode,
    cross_attention_decode_plain,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.ops.fused_attention_block import (
    fused_t5_ffn,
    fused_t5_ffn_plain,
    t5_attention_core,
    t5_attention_core_plain,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.tools import bench_generate as tbench
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import model_factory as tfactory
from explicit_alignment_for_vqa_tasks_tpu_torch.utils import config_system as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOTPOTQA = os.path.join(REPO, "configs/vqa2/few_shot_vqa_hotpotqa.jsonnet")
CLIP_CAP = os.path.join(REPO, "configs/vqa2/clip_cap.jsonnet")
S = 32099  # <extra_id_0>


@pytest.fixture(scope="module")
def J():
    """The JAX package's side (imported here, so that the gpu tests run
    where there is no jax)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from explicit_alignment_for_vqa_tasks_tpu import main
    from explicit_alignment_for_vqa_tasks_tpu.models import hf_convert, t5
    from explicit_alignment_for_vqa_tasks_tpu.trainers import model_factory
    from explicit_alignment_for_vqa_tasks_tpu.utils import config_system

    return SimpleNamespace(jax=jax, jnp=jnp, main=main, hf=hf_convert, t5=t5,
                           factory=model_factory, config=config_system)


def configs(J, path, *opts):
    argv = [path, "--mode", "test", "--opts", *opts]
    return (J.config.process_config(J.main.parse_args_sys(argv)),
            tconfig.process_config(tmain.parse_args_sys(argv)))


def fields(J, cfg):
    """A config dataclass's fields, nested ones too, the JAX dtype named as
    the port's."""
    dtypes = {J.jnp.bfloat16: torch.bfloat16, J.jnp.float32: torch.float32}
    out = {}
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value):
            value = fields(J, value)
        elif f.name == "dtype":
            value = dtypes.get(value, value)
        out[f.name] = value
    return out


def leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves(tree[k],
                                                          f"{prefix}/{k}")]
    return [(prefix, tree)]


def few_shot_batch(seed, num_shots=2, batch=3, length=14, prefix_size=768):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, 30000, (batch, length)).astype(np.int32)
    mask = np.ones((batch, length), np.int32)
    for b, pad in enumerate([0, 3, 1][:batch]):
        valid = length - pad
        tokens[b, valid:] = 0
        mask[b, valid:] = 0
        spots = sorted(rng.choice(valid - 1, num_shots + 1, replace=False))
        for g, j in enumerate(spots):
            tokens[b, j] = S - g
    prefix = rng.standard_normal((batch, num_shots + 1, prefix_size))
    return prefix.astype(np.float32), tokens, mask


@pytest.mark.parametrize("fused_decode", [False, True])
@pytest.mark.parametrize("fused_ffn", [False, True])
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_vct0_from_config_matches_jax(J, compute_dtype, fused_ffn,
                                      fused_decode):
    jcfg, tcfg = configs(
        J, HOTPOTQA, "model_config.ConfigClass=T5_test",
        "model_config.pretrained=0",
        f"tpu.compute_dtype={compute_dtype}", f"tpu.fused_ffn={fused_ffn}",
        f"model_config.lm_config.fused_decode_attention={fused_decode}")
    jmodel, jkind = J.factory.build_model_from_config(jcfg)
    tmodel, tkind = tfactory.build_model_from_config(tcfg, device="cpu")
    assert tkind == jkind == "vct0"
    assert fields(J, tmodel.cfg) == fields(J, jmodel.cfg)
    lm = tmodel.cfg.lm
    assert lm.dtype == getattr(torch, compute_dtype)
    assert (lm.fused_encoder_attention, lm.fused_encoder_ffn,
            lm.fused_decode_attention) == (True, fused_ffn, fused_decode)
    # the factory draws bf16 params (tpu.params_dtype) on the device asked
    assert tmodel.params["lm"]["shared"].dtype == torch.bfloat16
    assert tmodel.device == torch.device("cpu")
    # JAX's params carried across: the same greedy tokens
    tmodel.params = vct0_params_from_numpy(
        J.jax.tree.map(np.asarray, jmodel.params), torch.bfloat16, "cpu")
    prefix, tokens, mask = few_shot_batch(0)
    jtok, _ = jmodel.generate(J.jnp.asarray(prefix), J.jnp.asarray(tokens),
                              J.jnp.asarray(mask), num_shots=2,
                              max_new_tokens=4)
    ttok, tlp = tmodel.generate(prefix, tokens, mask, num_shots=2,
                                max_new_tokens=4)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert bool(torch.isfinite(tlp).all())


def test_factory_draws_the_in_code_params_from_the_seed(J, caplog,
                                                       monkeypatch):
    """As shipped (pretrained) on a machine without ``transformers`` (the
    card's): a logged warning, then init_vct0_params(cfg, seed) from the
    config's seed, leaf for leaf."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    _, tcfg = configs(J, HOTPOTQA, "model_config.ConfigClass=T5_test",
                      "seed=5")
    assert tcfg.model_config.pretrained
    model, _ = tfactory.build_model_from_config(tcfg, device="cpu")
    assert "using random init" in caplog.text
    want = leaves(tfactory.init_vct0_params(model.cfg, seed=5, device="cpu"))
    got = leaves(model.params)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("opts,q8", [
    (["tpu.int8_encoder_ffn=True", "tpu.int8_encoder_attn=True",
      "tpu.int8_decoder_step=True"], True),
    (["tpu.int8_encoder_ffn=True", "tpu.int8_calibrate_batches=2",
      "tpu.int8_smooth_alpha=0.25"], False),
])
def test_int8_options_as_jax_sets_them(J, opts, q8):
    jcfg, tcfg = configs(J, HOTPOTQA, "model_config.ConfigClass=T5_test",
                         "model_config.pretrained=0", *opts)
    jmodel, _ = J.factory.build_model_from_config(jcfg)
    tmodel, _ = tfactory.build_model_from_config(tcfg, device="cpu")
    assert fields(J, tmodel.cfg) == fields(J, jmodel.cfg)
    assert (getattr(tmodel, "pending_int8_calibration", None)
            == getattr(jmodel, "pending_int8_calibration", None))
    assert ([k for k, _ in leaves(tmodel.params)]
            == [k for k, _ in leaves(jmodel.params)])
    assert ("ffn_q8" in tmodel.params["lm"]["encoder"]) == q8


def test_lm_config_wins_over_the_tpu_block(J):
    jcfg, tcfg = configs(J, HOTPOTQA, "model_config.ConfigClass=T5_test",
                         "model_config.pretrained=0", "tpu.fused_ffn=True",
                         "model_config.lm_config.fused_encoder_ffn=False",
                         "model_config.lm_config.num_decoder_layers=1")
    jmodel, _ = J.factory.build_model_from_config(jcfg)
    tmodel, _ = tfactory.build_model_from_config(tcfg, device="cpu")
    assert fields(J, tmodel.cfg) == fields(J, jmodel.cfg)
    assert not tmodel.cfg.lm.fused_encoder_ffn
    assert tmodel.cfg.lm.num_decoder_layers == 1


def test_clip_cap_config_matches_jax(J):
    jcfg, tcfg = configs(J, CLIP_CAP, "model_config.ConfigClass=GPT2_test",
                         "model_config.pretrained=0")
    jmodel, jkind = J.factory.build_model_from_config(jcfg)
    tmodel, tkind = tfactory.build_model_from_config(tcfg, device="cpu")
    assert tkind == jkind == "clipcap"
    assert fields(J, tmodel.cfg) == fields(J, jmodel.cfg)


def test_unknown_model_class_raises(J):
    _, tcfg = configs(J, HOTPOTQA, "model_config.ModelClass=Nope")
    with pytest.raises(ValueError, match="unknown ModelClass: Nope"):
        tfactory.build_model_from_config(tcfg, device="cpu")


def test_t5_params_from_hf_matches_jax(J):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.T5Config(
        vocab_size=256, d_model=32, d_kv=8, num_heads=4, d_ff=64,
        num_layers=2, num_decoder_layers=2, feed_forward_proj="gated-gelu",
        tie_word_embeddings=False, dropout_rate=0.0,
        relative_attention_num_buckets=8, relative_attention_max_distance=16,
        decoder_start_token_id=0)
    torch.manual_seed(0)
    sd = transformers.T5ForConditionalGeneration(hf_cfg).eval().state_dict()
    kw = dict(vocab_size=256, d_model=32, d_kv=8, num_heads=4, d_ff=64,
              num_encoder_layers=2, num_decoder_layers=2,
              relative_attention_num_buckets=8,
              relative_attention_max_distance=16)
    got = thf.t5_params_from_hf(sd, tt5.T5Config(**kw))
    want = leaves(J.hf.t5_params_from_hf(sd, J.t5.T5Config(**kw)))
    got = leaves(got)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def jax_bench_keys():
    """The keys of the JSON line the root bench_generate.py prints, and of
    its ``config``, read from its source."""
    tree = ast.parse(open(os.path.join(REPO, "bench_generate.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and isinstance(node.args[0], ast.Dict)):
            line = node.args[0]
            keys = [k.value for k in line.keys]
            config = line.values[keys.index("config")]
            return keys, [k.value for k in config.keys]
    raise AssertionError("no json.dumps line in bench_generate.py")


@pytest.mark.parametrize("flags", [[], ["--fused_ffn", "--int8_attn",
                                        "--int8_groups", "1"]])
def test_bench_body_runs_and_prints_jax_keys(flags, capsys):
    args = tbench.build_parser().parse_args(
        ["--batch", "2", "--seq", "30", "--shots", "1", "--decode_steps",
         "2", "--trials", "1", *flags])
    result = tbench.bench(args, tt5.T5Config.small_test(), "cpu")
    keys, config_keys = jax_bench_keys()
    assert list(result) == keys + ["device"]
    assert list(result["config"]) == config_keys
    assert result["metric"] == \
        "vct0_3b_fewshot_generate_prompts_per_sec_per_chip"
    assert result["config"]["spliced_length"] == 30 + 9 * 2
    assert result["value"] > 0 and result["device"]["name"] == "cpu"
    assert result["config"]["int8_encoder_attn"] == ("--int8_attn" in flags)
    assert "prompts/s" in capsys.readouterr().err


@pytest.mark.parametrize("flags,want", [
    (["--eos_step1"], {"eos_step1": True}),
    (["--eos_at_steps", "2,3"], {"eos_at_steps": "2,3"}),
    (["--prefill_chunks", "2"], {"prefill_chunks": 2}),
    (["--ensembles", "2"], {"ensembles": 2, "members_per_call": 1,
                            "prefill_chunks": None}),
    (["--members_per_call", "2"], {"ensembles": None,
                                   "members_per_call": None}),
    (["--ensembles", "3", "--members_per_call", "3"],
     {"ensembles": 3, "members_per_call": 3}),
])
def test_bench_flags_run_with_jax_keys(flags, want, capsys):
    """Each flag of the JAX bench runs the bench's body (at a small width)
    and prints the JAX bench's keys; the ensemble path records no
    prefill_chunks, which it does not take."""
    args = tbench.build_parser().parse_args(
        ["--batch", "2", "--seq", "30", "--shots", "1", "--decode_steps",
         "3", "--trials", "1", *flags])
    result = tbench.bench(args, tt5.T5Config.small_test(), "cpu")
    keys, config_keys = jax_bench_keys()
    assert list(result) == keys + ["device"]
    assert list(result["config"]) == config_keys
    assert result["value"] > 0
    for key, value in want.items():
        assert result["config"][key] == value
    forced = result["config"]["mean_forced_answer_len"]
    assert (forced is not None) == ("--eos_at_steps" in flags)
    if forced is not None:
        assert 2 <= forced <= 3
    assert "prompts/s" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--prefill_chunks", "2"],
                                   ["--eos_at_steps", "2,3"]])
def test_bench_refuses_main_path_knobs_beside_ensembles(flags):
    args = tbench.build_parser().parse_args(["--ensembles", "2", *flags])
    with pytest.raises(ValueError, match="main generate path only"):
        tbench.bench(args, tt5.T5Config.small_test(), "cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card and without device="cpu" the factory and the bench
    raise; they never move to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = tconfig.process_config(tmain.parse_args_sys(
        [HOTPOTQA, "--opts", "model_config.ConfigClass=T5_test"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfactory.build_model_from_config(config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbench.bench(tbench.build_parser().parse_args([]),
                     tt5.T5Config.small_test())


def test_bench_defaults_are_jax_s():
    args = tbench.build_parser().parse_args([])
    assert (args.batch, args.seq, args.shots, args.decode_steps,
            args.trials, args.prefill_chunks) == (32, 512, 4, 20, 3, 1)


# --- on the card: the fp32 forms against their plain versions --------------

def card_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,length,heads,head_dim,padded", [
    (4, 557, 32, 64, 100),   # the main path's widths; 100 keys padded
    (3, 130, 5, 128, 0),
    (2, 1, 3, 64, 0),        # a single key
    (2, 65, 4, 64, 1),       # a ragged tile of one key
    (2, 1700, 2, 64, 300),   # longer than one shared-memory score row
])
def test_cuda_fp32_attention_core_matches_plain(batch, length, heads,
                                                head_dim, padded):
    """fp32: within 1e-5 (1 + |want|) of the plain version, one launch
    counted; the last row, fully masked, is the mean of v over all keys."""
    gen = card_gen()
    width = heads * head_dim

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    q, k = randn(batch, length, width, scale=0.5), randn(batch, length,
                                                         width, scale=0.5)
    v = torch.rand((batch, length, width), generator=gen, device="cuda") * 2 - 1
    bias = randn(heads, length, length)
    mask = torch.ones((batch, length), dtype=torch.int32, device="cuda")
    if padded:
        mask[0, length - padded:] = 0
    mask[batch - 1] = 0
    before = t5_attention_core.launches
    got = t5_attention_core(q, k, v, bias, mask, heads)
    torch.cuda.synchronize()
    assert t5_attention_core.launches == before + 1
    assert not torch.backends.cuda.matmul.allow_tf32
    want = t5_attention_core_plain(q, k, v, bias, mask, heads)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[batch - 1],
                               v[batch - 1].mean(dim=0).expand(length, -1),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="bias_tiles"):
        t5_attention_core(q, k, v, bias, mask, heads, bias)


@pytest.mark.gpu
@pytest.mark.parametrize("layers,batch,length,heads,head_dim,layer,padded", [
    (24, 4, 557, 32, 64, 7, 100),   # the main path's widths; 100 padded keys
    (3, 3, 37, 3, 16, 2, 0),
    (2, 2, 130, 5, 128, 0, 7),
    (2, 2, 13000, 4, 32, 1, 0),     # a score row past 48 KB of shared memory
])
def test_cuda_fp32_decode_attention_matches_plain(layers, batch, length,
                                                  heads, head_dim, layer,
                                                  padded):
    gen = card_gen()
    width = heads * head_dim

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q = randn(batch, width)
    k, v = randn(layers, batch, length, width), randn(layers, batch, length,
                                                       width)
    mask = torch.ones((batch, length), dtype=torch.int32, device="cuda")
    if padded:
        mask[0, length - padded:] = 0
    mask[batch - 1] = 0
    before = cross_attention_decode.launches
    got = cross_attention_decode(q, k, v, mask, layer, heads)
    torch.cuda.synchronize()
    assert cross_attention_decode.launches == before + 1
    want = cross_attention_decode_plain(q, k, v, mask, layer, heads)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="one dtype"):
        cross_attention_decode(q, k.bfloat16(), v.bfloat16(), mask, layer,
                               heads)


@pytest.mark.gpu
@pytest.mark.parametrize("ln_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [64, 157, 300])
@pytest.mark.parametrize("gated", [True, False])
def test_cuda_fp32_ffn_matches_plain(gated, rows, ln_dtype):
    """fp32 x at T0-3B widths, the weights bf16 and, cast in the wrapper,
    fp32: the rule of the bf16 form's test (relative Frobenius error within
    2e-3, every element within 1.6e-2 of |want| + rms(want); an fp32 sum in
    another order can move a bf16 rounding of h or hid)."""
    gen = card_gen()
    d_model, d_ff = 2048, 5120

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x = randn(1, rows, d_model, scale=2.0)
    lnw = (1 + 0.1 * randn(d_model)).to(ln_dtype)
    wi_0 = randn(d_model, d_ff, scale=d_model ** -0.5).bfloat16()
    wi_1 = randn(d_model, d_ff, scale=d_model ** -0.5).bfloat16() \
        if gated else None
    wo = randn(d_ff, d_model, scale=d_ff ** -0.5).bfloat16()
    before = fused_t5_ffn.launches
    got = fused_t5_ffn(x, lnw, wi_0, wi_1, wo)
    torch.cuda.synchronize()
    assert fused_t5_ffn.launches == before + 1
    assert got.dtype == torch.float32
    want = fused_t5_ffn_plain(x, lnw, wi_0, wi_1, wo)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 2e-3, rel
    rms = want.square().mean().sqrt()
    assert bool(((got - want).abs() <= 1.6e-2 * (want.abs() + rms)).all())
    # fp32 weights are cast to bf16 in the wrapper: the same bits
    fp32_w = fused_t5_ffn(x, lnw, wi_0.float(),
                          wi_1.float() if gated else None, wo.float())
    assert torch.equal(fp32_w, got)
